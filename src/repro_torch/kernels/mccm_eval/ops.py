"""Dispatch and shared static tables for the MCCM evaluation kernels: the
fused parallelism search and the Eq. 1 latency sweep.

The tensor's device picks the route: a CPU tensor runs the plain PyTorch
version (``ref.parallelism_search_ref``, ``ref.mccm_latency_ref``), a CUDA
tensor launches the hand-written kernel (``csrc/parallelism_search.cu``,
``csrc/mccm_latency.cu``) or raises.  There is no fallback from the card to
the plain version.

The search kernel runs one design a warp, a block striding over the batch
after it has staged the tables every design shares: fc·coh and
ceil(OW/cand) of the layers its designs map, in shared memory.
:func:`search_plan` chooses the warps a block, the blocks, the pairs a
lane holds and how many leading layers are staged; the kernel checks the
plan and refuses one it cannot run.  :func:`last_launch` is the plan of the
last launch.

The latency kernel is a persistent stream: as many blocks as the SMs keep
resident, each walking tiles of designs in order; a producer warp streams
each tile's ⟨pf, ph, pw⟩ through a ring of shared-memory stages by TMA bulk
copies, while 16 consumer warps compute the cycles, store them 16 bytes a
lane, and then add each design's row, one design a thread.
The library works out its own plan and reports it
(:func:`latency_launch_plan`); :func:`latency_plan` is the same plan in
plain Python, which the CPU tests hold to the card's limits, and
:func:`last_latency_launch` the plan of the last launch.
"""
from __future__ import annotations

import ctypes
from dataclasses import asdict, dataclass
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ...gpu import op_walk
from .. import _COPIES, _LAUNCHES
from .ref import mccm_latency_ref, parallelism_search_ref

NC = 16      # CEs per design: the kernel's compile-time width

SOURCE = Path(__file__).resolve().parent / "csrc" / "parallelism_search.cu"
LATENCY_SOURCE = SOURCE.with_name("mccm_latency.cu")

#: most layers the latency kernel takes (``csrc/mccm_latency.cu``'s MAX_L),
#: the limit of its first design, kept (the stream's shared memory would
#: hold a tile of 4 designs up to 5,212 layers)
LATENCY_MAX_L = 2457
#: the latency kernel's block: consumer threads (16 warps; each adds at
#: most one design's cycles), the stages of its ring, the elements a
#: consumer takes a stage, and the (design, layer) elements a stage holds
LAT_CONSUMERS, LAT_STAGES, LAT_STEPS = 512, 4, 2
LAT_THREADS = LAT_CONSUMERS + 32          # and one producer warp
LAT_CHUNK = LAT_STEPS * LAT_CONSUMERS
#: a block's mbarriers, its ring (each stage a chunk's par, with 16 bytes
#: of slack for a misaligned par) and a chunk's cycles on their way out
LAT_RING = (16 * LAT_STAGES + LAT_STAGES * (12 * LAT_CHUNK + 16)
            + 4 * LAT_CHUNK)
#: an SM's threads
SM_THREADS = 2048

#: the search kernel's limits (``csrc/parallelism_search.cu``): designs a
#: block has in flight (a warp each), the most pairs a lane holds in
#: registers, the floats of shared memory past the staged fc·coh rows that
#: lanes past the last pair read (and discard), and the bytes of its pw
#: table
MAX_WARPS, NPL_MAX, SLACK, LUT_N = 16, 11, 32 * 11, 2048
#: the pairs a lane holds in each of the kernel's instantiations: the
#: batch path's pair lists (219, 264, 312 and 324 pairs) need 7, 9, 10 and
#: 11, a shorter list takes 7 and a longer one walks groups of 11 a lane
NPLS = (7, 9, 10, 11)
#: dynamic shared memory a block may have, and an SM's (H100: 227 KB and
#: 228 KB, of which 1 KB a resident block keeps for itself)
MAX_SMEM, SM_SMEM, SMEM_PER_BLOCK = 232_448, 233_472, 1024
#: an H100 SXM's SMs, and the warps and blocks an SM holds
SMS, SM_WARPS, SM_BLOCKS = 132, 64, 32

#: the search entry point's refusals (negative returns)
_REFUSALS = {-1: "bad shape", -2: "bad pairs a lane", -3: "bad warps",
             -4: "bad staged rows", -5: "bad shared-memory size",
             -6: "bad block count"}
#: the latency entry point's refusals
_LATENCY_REFUSALS = {-1: "bad shape", -2: "no tile fits",
                     -3: "misaligned pointer"}


class PairTables(NamedTuple):
    """Static ⟨pf, ph⟩ pair list, row-major over the candidate grid
    (host arrays)."""

    pair_i: np.ndarray      # (P,) i32 index into cand (pf)
    pair_j: np.ndarray      # (P,) i32 index into cand (ph)
    pair_prod: np.ndarray   # (P,) f32 pf*ph
    pair_pf: np.ndarray     # (P,) f32
    pair_ph: np.ndarray     # (P,) f32
    cand: np.ndarray        # (K,) f32 ascending


@lru_cache(maxsize=None)
def pair_tables(candidates: tuple, pes_hint: int | None) -> PairTables:
    """Flatten the candidate grid, pruning pairs with pf*ph > pes_hint.

    Pruned pairs are infeasible for every CE of every device whose total
    PE count is <= ``pes_hint`` (per-CE allocations never exceed the
    total), so the argmin over the pruned list selects exactly the pair
    the full-grid argmin would.  ``pes_hint=None`` keeps every pair.
    """
    cand = np.asarray(candidates, np.float64)
    k = len(cand)
    ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()                 # row-major (i, j)
    prod = cand[ii] * cand[jj]
    if pes_hint is not None:
        keep = prod <= pes_hint
        keep[0] = True                              # (1, 1) always survives
        ii, jj, prod = ii[keep], jj[keep], prod[keep]
    return PairTables(ii.astype(np.int32), jj.astype(np.int32),
                      prod.astype(np.float32),
                      cand[ii].astype(np.float32),
                      cand[jj].astype(np.float32),
                      cand.astype(np.float32))


#: test-only fault-injection seam: when set, called as
#: ``hook("parallelism_search", route)`` at every dispatch, with route
#: "cuda" or "ref"; a raising hook fails the call
_FAULT_HOOK = None


def set_fault_hook(hook):
    """Install (or, with ``None``, uninstall) the fault-injection hook;
    returns the previous hook so tests can restore it."""
    global _FAULT_HOOK
    prev, _FAULT_HOOK = _FAULT_HOOK, hook
    return prev


#: each kernel's source, C entry point and argument types (ctypes.c_void_p
#: for every pointer and the stream, ctypes.c_int for an int)
_KERNELS = {
    "parallelism_search": (SOURCE, "mccm_parallelism_search",
                           [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p]),
    "mccm_latency": (LATENCY_SOURCE, "mccm_latency",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p]),
}

_BUILT: dict = {}
_LAST = None
_LAST_LATENCY = None


@dataclass(frozen=True)
class SearchPlan:
    """How the search kernel covers a batch (see
    ``csrc/parallelism_search.cu``)."""

    warps: int              # designs a block has in flight, a warp each
    blocks: int             # the grid; a block strides over the designs
    designs_per_block: int  # most designs one block evaluates
    npl: int                # pairs a lane holds in registers
    pair_groups: int        # passes over the pair list for each CE
    staged_rows: int        # leading layers whose tables are staged
    smem_bytes: int         # staged rows, slack, row count, pw table

    def as_dict(self) -> dict:
        return asdict(self)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def search_smem(rows: int, P: int, K: int) -> int:
    """Shared-memory bytes of a block that stages ``rows`` layers: an
    fc·coh row of P floats and a ceil(OW/cand) row of K floats each, the
    slack after the fc·coh rows, the count of rows it stages and the pw
    table (a byte for each floor of pes/(pf·ph) below ``LUT_N``)."""
    return 4 * (rows * (P + K) + SLACK + 1) + LUT_N


@lru_cache(maxsize=4096)
def search_plan(B: int, L: int, P: int, K: int) -> SearchPlan:
    """The search kernel's launch plan for B designs, L (padded) layers, P
    pairs and K candidates.

    Every layer is staged that fits in a block's shared memory: all L
    whenever L·(P + K) floats do (every net the batch path pads to 160
    layers, at every pair list up to the full 18 × 18), else the leading
    rows, the rest read from L2 at a higher cost a term.  A block has one
    warp a design in flight, up to ``MAX_WARPS``, as many as spread the
    batch over the card's SMs; the grid holds as many blocks as the SMs
    keep resident, and each strides over the designs.  A lane holds the
    least of ``NPLS`` pairs that covers the list in one group, else
    ``NPL_MAX`` and the list is walked in groups.  Raises ``ValueError``
    for an empty batch, layer list, pair list or candidate list; every
    other shape has a plan.
    """
    if min(B, L, P, K) < 1:
        raise ValueError(f"the search needs B, L, P, K >= 1, got {B}, {L}, "
                         f"{P}, {K}")
    npl = next((n for n in NPLS if 32 * n >= P), NPL_MAX)
    rows = min(L, (MAX_SMEM - search_smem(0, P, K)) // (4 * (P + K)))
    smem = search_smem(rows, P, K)
    warps = max(1, min(MAX_WARPS, _cdiv(B, SMS)))
    resident = max(1, min(SM_BLOCKS, SM_WARPS // warps,
                          SM_SMEM // (smem + SMEM_PER_BLOCK)))
    slots = _cdiv(B, warps)
    blocks = min(slots, SMS * resident)
    return SearchPlan(warps, blocks, _cdiv(slots, blocks) * warps, npl,
                      _cdiv(P, 32 * npl), rows, smem)


@dataclass(frozen=True)
class LatencyPlan:
    """How the latency kernel covers a batch (see
    ``csrc/mccm_latency.cu``)."""

    threads: int            # a block's: the consumers and a producer warp
    tile: int               # designs a tile, at most one a consumer
    stages: int             # stages of the ring
    smem_bytes: int         # ring, dims table, the tile's cycle rows
    blocks_per_sm: int      # what the SM's shared memory and threads allow
    grid: int               # blocks, each walking tiles in order

    def as_dict(self) -> dict:
        return asdict(self)


def latency_smem(L: int, T: int) -> int:
    """Shared-memory bytes of a latency block at L layers and a tile of T
    designs: the ring, the (L, 4) dims table and T cycle rows padded to an
    odd stride (``L | 1``)."""
    return LAT_RING + 16 * L + 4 * T * (L | 1)


def _latency_bps(smem: int) -> int:
    return min(SM_SMEM // (smem + SMEM_PER_BLOCK), SM_THREADS // LAT_THREADS,
               SM_BLOCKS)


@lru_cache(maxsize=4096)
def latency_plan(B: int, L: int) -> LatencyPlan:
    """The latency kernel's launch plan for B designs of L layers, worked
    out as ``csrc/mccm_latency.cu``'s ``make_plan`` works it out.

    A tile holds at most one design a consumer thread, and as many as the
    shared memory left by the ring and the dims table takes in cycle rows,
    and T·L is a multiple of 4 (so every tile's spans of par and cycles
    keep the base pointers' 16-byte alignment).  A batch of few designs
    takes tiles of about B / 132, so that it still spreads over the SMs.
    The tile then shrinks to the least that needs no more rounds of the
    resident blocks, and the grid is as many blocks as the SMs keep
    resident, or the tiles if fewer.  Raises ``ValueError`` where the
    library refuses: B < 1, L < 1 or L > ``LATENCY_MAX_L``.
    """
    if B < 1 or not 1 <= L <= LATENCY_MAX_L:
        raise ValueError(f"the latency kernel takes B >= 1 and 1 <= L <= "
                         f"{LATENCY_MAX_L}, got B {B}, L {L}")
    q = 1 if L % 4 == 0 else 2 if L % 2 == 0 else 4
    fit = (MAX_SMEM - latency_smem(L, 0)) // (4 * (L | 1)) // q * q
    t0 = min(_cdiv(_cdiv(B, SMS), q) * q, LAT_CONSUMERS, fit)
    bps0 = _latency_bps(latency_smem(L, t0))
    rounds = _cdiv(_cdiv(B, t0), SMS * bps0)
    t = min(t0, _cdiv(_cdiv(B, SMS * bps0 * rounds), q) * q)
    smem = latency_smem(L, t)
    bps = _latency_bps(smem)
    return LatencyPlan(LAT_THREADS, t, LAT_STAGES, smem, bps,
                       min(_cdiv(B, t), SMS * bps))


def latency_launch_plan(B: int, L: int) -> LatencyPlan:
    """The plan the latency library reports for B designs of L layers
    (``mccm_latency_plan``; builds the library at its first call)."""
    plan = (ctypes.c_int * 6)()
    err = library("mccm_latency").lib.mccm_latency_plan(B, L, plan)
    if err != 0:
        raise ValueError(f"mccm_latency refuses B {B}, L {L}: "
                         f"{_LATENCY_REFUSALS.get(err, err)}")
    return LatencyPlan(*plan)


def last_latency_launch() -> LatencyPlan | None:
    """The plan of the most recent latency launch of this process, as the
    library reports it (None before the first)."""
    return None if _LAST_LATENCY is None else latency_launch_plan(
        *_LAST_LATENCY)


def last_launch() -> SearchPlan | None:
    """The plan of the most recent search launch of this process (None
    before the first)."""
    return _LAST


def library(name: str):
    """The library of kernel ``name`` (a key of ``_KERNELS``), built at the
    first call (an ``_nvcc.Built`` record: the loaded library, its path,
    build seconds, ptxas report), with its C signature declared."""
    if name not in _BUILT:
        from .._nvcc import load
        source, symbol, argtypes = _KERNELS[name]
        built = load(source)
        fn = getattr(built.lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        if name == "mccm_latency":
            plan = built.lib.mccm_latency_plan
            plan.argtypes = [ctypes.c_int, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int)]
            plan.restype = ctypes.c_int
        _BUILT[name] = built
    return _BUILT[name]


def parallelism_search_cuda(pes_ce, ce_idx, fc_pair, coh_pair, ow, cand,
                            pair_prod, pair_pf, pair_ph):
    """Launch the CUDA kernel on the current stream.

    The arguments of ``parallelism_search_ref``: pes_ce (B, NC) f32;
    ce_idx (B, L) int32, -1 for a layer with no CE; fc_pair / coh_pair
    (L, P) f32; ow (L,) f32; cand (K,) f32 ascending; pair_* (P,) f32, all
    on one CUDA device.  Returns (pf, ph, pw, cost) each (B, NC) f32, equal
    to ``parallelism_search_ref`` on the same inputs bit for bit wherever
    every term (fc·coh)·ceil(OW/pw) is finite, as on every table the batch
    path builds (a non-finite term reaches other CEs' costs in the plain
    version only, through its one-hot product); a NaN cost wins the
    argmin, the first one, as in ``torch.argmin``.  The launch runs
    :func:`search_plan`'s plan, which :func:`last_launch` then returns.
    """
    global _LAST
    args = dict(pes_ce=pes_ce, ce_idx=ce_idx, fc_pair=fc_pair,
                coh_pair=coh_pair, ow=ow, cand=cand, pair_prod=pair_prod,
                pair_pf=pair_pf, pair_ph=pair_ph)
    dev = pes_ce.device
    for name, a in args.items():
        if a.device != dev or a.device.type != "cuda":
            raise ValueError(f"{name} is on {a.device}; every argument "
                             f"must be on one CUDA device ({dev})")
        want = torch.int32 if name == "ce_idx" else torch.float32
        if a.dtype != want:
            raise TypeError(f"{name} must be {want}, got {a.dtype}")
    B, nc = pes_ce.shape
    L, P = fc_pair.shape
    K = cand.numel()
    if nc != NC or ce_idx.shape != (B, L):
        raise ValueError(f"pes_ce {tuple(pes_ce.shape)} / ce_idx "
                         f"{tuple(ce_idx.shape)} must be (B, {NC}) / "
                         f"(B, {L})")
    if coh_pair.shape != (L, P) or ow.numel() != L or K < 1 or P < 1 \
            or any(a.numel() != P for a in (pair_prod, pair_pf, pair_ph)):
        raise ValueError("fc_pair/coh_pair must be (L, P), ow (L,), "
                         "pair_* (P,) and cand non-empty")
    c = [a.contiguous() for a in args.values()]
    outs = [torch.empty(B, NC, dtype=torch.float32, device=dev)
            for _ in range(4)]
    if B == 0:
        return tuple(outs)
    plan = search_plan(B, L, P, K)
    built = library("parallelism_search")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = built.lib.mccm_parallelism_search(
            *(a.data_ptr() for a in c), *(o.data_ptr() for o in outs),
            B, L, P, K, plan.warps, plan.blocks, plan.staged_rows, plan.npl,
            plan.smem_bytes, stream)
    if err < 0:
        raise RuntimeError(f"parallelism_search refused its launch plan "
                           f"({_REFUSALS.get(err, err)}): {plan}")
    if err != 0:
        raise RuntimeError(f"parallelism_search kernel launch failed: "
                           f"CUDA error {err}")
    _LAUNCHES["parallelism_search"] += 1
    _LAST = plan
    return tuple(outs)


def search_cost(pes_ce, ce_idx, fc_pair, coh_pair, ow, cand, pair_prod,
                pair_pf, pair_ph) -> dict:
    """The work the search needs on these inputs, the kernel's and its
    bound's: every input read once, the four (B, 16) f32 outputs written
    once, and the f32 operations (``flops``) these inputs need.

    A multiply and an add for each (design, mapped layer, feasible pair of
    the layer's CE): an infeasible pair costs inf whatever its sum.  fc·coh
    (one multiply a live layer and pair) and ceil(OW/cand) (a division and
    a ceil a live layer and candidate) are tables every design shares; a
    live layer is one a design of the batch maps.  For each (design, CE
    that owns a layer, pair), the quotient pes/(pf·ph), and for each
    feasible one its floor and the argmin's compare.  A CE that owns no
    layer takes its first feasible pair: at most one quotient, not
    counted.  The parts: ``ops_walk``, ``ops_per_ce``, ``ops_tables``;
    ``ops_5`` is the earlier, coarser count: 5 operations a pair for each
    mapped (design, layer).  Reads the data, so it syncs with the device.
    """
    args = (pes_ce, ce_idx, fc_pair, coh_pair, ow, cand, pair_prod, pair_pf,
            pair_ph)
    P, K = fc_pair.shape[1], cand.numel()
    mapped = ce_idx >= 0
    owned = torch.zeros_like(pes_ce).scatter_add_(
        1, ce_idx.clamp_min(0).long(), mapped.to(pes_ce.dtype))   # (B, NC)
    feasible = (pes_ce[:, :, None] / pair_prod[None, None, :] >= 1).sum(-1)
    walked = owned > 0
    live = int(mapped.any(0).sum())
    walk = 2 * int((owned * feasible).sum())
    per_ce = P * int(walked.sum()) + 2 * int((feasible * walked).sum())
    tables = live * P + 2 * live * K
    return dict(flops=walk + per_ce + tables, transcendentals=0,
                bytes=4 * sum(a.numel() for a in args)
                + 4 * 4 * pes_ce.shape[0] * NC,
                dtype=torch.float32, live_layers=int(mapped.sum()),
                live_rows=live, ops_walk=walk, ops_per_ce=per_ce,
                ops_tables=tables, ops_5=5 * P * int(mapped.sum()))


def latency_cost(B: int, L: int) -> dict:
    """The work of the latency function at B designs of L layers, the
    kernel's and its bound's: dims and par read once, the totals and
    cycles written once, and 10 f32 operations an element (3 divisions,
    3 ceils, 3 products, 1 add)."""
    return dict(flops=10 * B * L, transcendentals=0,
                bytes=4 * (4 * L + 3 * B * L + B + B * L),
                dtype=torch.float32)


def parallelism_search(pes_ce, ce_idx, fc_pair, coh_pair, ow, cand,
                       pair_prod, pair_pf, pair_ph):
    """The fused search, routed by the tensors' device.

    Takes the arguments of ``parallelism_search_ref``.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel, and an error
    there propagates.  Inside an ``op_walk.OpWalk`` either route is charged
    :func:`search_cost` as ``parallelism_search``.
    """
    route = "cuda" if pes_ce.device.type == "cuda" else "ref"
    if _FAULT_HOOK is not None:
        _FAULT_HOOK("parallelism_search", route)
    args = (pes_ce, ce_idx, fc_pair, coh_pair, ow, cand, pair_prod, pair_pf,
            pair_ph)
    with op_walk.charge("parallelism_search", lambda: search_cost(*args)):
        if route == "cuda":
            return parallelism_search_cuda(*args)
        if pes_ce.device.type != "cpu":
            raise ValueError(f"no parallelism_search route for a tensor on "
                             f"{pes_ce.device}; use a CPU or CUDA tensor")
        return parallelism_search_ref(*args)


def mccm_latency_cuda(dims, par):
    """Launch the Eq. 1 latency kernel on the current stream.

    dims (L, 4) f32 [F, C*KH*KW, OH, OW] and par (B, L, 3) f32 ⟨pf, ph,
    pw⟩, both on one CUDA device.  Returns ((B,) totals, (B, L) cycles),
    equal to ``mccm_latency_ref`` on the same inputs bit for bit (NaN where
    it has NaN).  A contiguous par is read where it lies, at any 4-byte
    alignment; another is copied first, and the copy counted in
    ``copies()["mccm_latency"]``.  The launch runs :func:`latency_plan`'s
    plan, which :func:`last_latency_launch` then returns as the library
    reports it.
    """
    global _LAST_LATENCY
    for name, a in (("dims", dims), ("par", par)):
        if a.device != dims.device or a.device.type != "cuda":
            raise ValueError(f"{name} is on {a.device}; both arguments "
                             f"must be on one CUDA device ({dims.device})")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {a.dtype}")
    if dims.dim() != 2 or dims.shape[1] != 4 or par.dim() != 3 \
            or par.shape[1:] != (dims.shape[0], 3):
        raise ValueError(f"dims {tuple(dims.shape)} / par "
                         f"{tuple(par.shape)} must be (L, 4) / (B, L, 3)")
    B, L = par.shape[0], dims.shape[0]
    if not 1 <= L <= LATENCY_MAX_L:
        raise ValueError(f"the latency kernel takes 1 to {LATENCY_MAX_L} "
                         f"layers, got {L}")
    if not par.is_contiguous():
        _COPIES["mccm_latency"] += 1
    dims, par = dims.contiguous(), par.contiguous()
    tot = torch.empty(B, dtype=torch.float32, device=dims.device)
    cyc = torch.empty(B, L, dtype=torch.float32, device=dims.device)
    if B == 0:
        return tot, cyc
    built = library("mccm_latency")
    with torch.cuda.device(dims.device):
        stream = torch.cuda.current_stream(dims.device).cuda_stream
        err = built.lib.mccm_latency(dims.data_ptr(), par.data_ptr(),
                                     tot.data_ptr(), cyc.data_ptr(), B, L,
                                     stream)
    if err < 0:
        raise RuntimeError(f"mccm_latency refused its launch "
                           f"({_LATENCY_REFUSALS.get(err, err)}): B {B}, "
                           f"L {L}")
    if err != 0:
        raise RuntimeError(f"mccm_latency kernel launch failed: CUDA error "
                           f"{err}")
    _LAUNCHES["mccm_latency"] += 1
    _LAST_LATENCY = (B, L)
    return tot, cyc


def mccm_latency(dims, par):
    """Eq. 1 over a design batch, routed by the tensors' device.

    dims (L, 4) f32 [F, C*KH*KW, OH, OW]; par (B, L, 3) f32 ⟨pf, ph, pw⟩
    of each design's layers.  Returns ((B,) total Eq. 1 cycles, (B, L)
    per-layer cycles).  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, and an error there propagates.

    The JAX package's ``mccm_latency`` also takes ``design_blk`` and
    ``interpret``: the TPU kernel's design tile and its CPU interpreter.
    Neither has a counterpart here (the CUDA kernel picks its own tile,
    :func:`latency_plan`, and the CPU runs the plain version), so the port
    drops both.  Inside an ``op_walk.OpWalk`` either route is charged
    :func:`latency_cost` as ``mccm_latency``.
    """
    with op_walk.charge("mccm_latency", lambda: latency_cost(
            par.shape[0], dims.shape[0])):
        if dims.device.type == "cuda":
            return mccm_latency_cuda(dims, par)
        if dims.device.type != "cpu":
            raise ValueError(f"no mccm_latency route for a tensor on "
                             f"{dims.device}; use a CPU or CUDA tensor")
        return mccm_latency_ref(dims, par)
