"""Dispatch and shared static tables for the MCCM evaluation kernels: the
fused parallelism search and the Eq. 1 latency sweep.

The tensor's device picks the route: a CPU tensor runs the plain PyTorch
version (``ref.parallelism_search_ref``, ``ref.mccm_latency_ref``), a CUDA
tensor launches the hand-written kernel (``csrc/parallelism_search.cu``,
``csrc/mccm_latency.cu``) or raises.  There is no fallback from the card to
the plain version.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .. import _LAUNCHES
from .ref import mccm_latency_ref, parallelism_search_ref

NC = 16      # CEs per design: the kernel's compile-time width

SOURCE = Path(__file__).resolve().parent / "csrc" / "parallelism_search.cu"
LATENCY_SOURCE = SOURCE.with_name("mccm_latency.cu")

#: most layers the latency kernel takes: its (L, 4) dims table and one
#: design's (L + 1)-word row of cycles fill its 48 KB of shared memory
LATENCY_MAX_L = 2457


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
                           [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
                           + [ctypes.c_void_p]),
    "mccm_latency": (LATENCY_SOURCE, "mccm_latency",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p]),
}

_BUILT: dict = {}


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
        _BUILT[name] = built
    return _BUILT[name]


def parallelism_search_cuda(pes_ce, ce_idx, fc_pair, coh_pair, ow, cand,
                            pair_prod, pair_pf, pair_ph):
    """Launch the CUDA kernel on the current stream.

    The arguments of ``parallelism_search_ref``: pes_ce (B, NC) f32;
    ce_idx (B, L) int32, -1 for a layer with no CE; fc_pair / coh_pair
    (L, P) f32; ow (L,) f32; cand (K,) f32 ascending; pair_* (P,) f32, all
    on one CUDA device.  Returns (pf, ph, pw, cost) each (B, NC) f32, equal
    to ``parallelism_search_ref`` on the same inputs.
    """
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
    built = library("parallelism_search")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = built.lib.mccm_parallelism_search(
            *(a.data_ptr() for a in c), *(o.data_ptr() for o in outs),
            B, L, P, K, stream)
    if err != 0:
        raise RuntimeError(f"parallelism_search kernel launch failed: "
                           f"CUDA error {err}")
    _LAUNCHES["parallelism_search"] += 1
    return tuple(outs)


def parallelism_search(pes_ce, ce_idx, fc_pair, coh_pair, ow, cand,
                       pair_prod, pair_pf, pair_ph):
    """The fused search, routed by the tensors' device.

    Takes the arguments of ``parallelism_search_ref``.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel, and an error
    there propagates.
    """
    route = "cuda" if pes_ce.device.type == "cuda" else "ref"
    if _FAULT_HOOK is not None:
        _FAULT_HOOK("parallelism_search", route)
    args = (pes_ce, ce_idx, fc_pair, coh_pair, ow, cand, pair_prod, pair_pf,
            pair_ph)
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
    equal to ``mccm_latency_ref`` on the same inputs bit for bit.
    """
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
    if err != 0:
        raise RuntimeError(f"mccm_latency kernel launch failed: CUDA error "
                           f"{err}")
    _LAUNCHES["mccm_latency"] += 1
    return tot, cyc


def mccm_latency(dims, par):
    """Eq. 1 over a design batch, routed by the tensors' device.

    dims (L, 4) f32 [F, C*KH*KW, OH, OW]; par (B, L, 3) f32 ⟨pf, ph, pw⟩
    of each design's layers.  Returns ((B,) total Eq. 1 cycles, (B, L)
    per-layer cycles).  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel, and an error there propagates.

    The JAX package's ``mccm_latency`` also takes ``design_blk`` and
    ``interpret``: the TPU kernel's design tile and its CPU interpreter.
    Neither has a counterpart here (the CUDA kernel picks its own tile, and
    the CPU runs the plain version), so the port drops both.
    """
    if dims.device.type == "cuda":
        return mccm_latency_cuda(dims, par)
    if dims.device.type != "cpu":
        raise ValueError(f"no mccm_latency route for a tensor on "
                         f"{dims.device}; use a CPU or CUDA tensor")
    return mccm_latency_ref(dims, par)
