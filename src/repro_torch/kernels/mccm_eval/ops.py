"""Dispatch and shared static tables for the MCCM parallelism search.

The tensor's device picks the route: a CPU tensor runs the plain PyTorch
version (``ref.parallelism_search_ref``), a CUDA tensor launches the
hand-written kernel (``csrc/parallelism_search.cu``) or raises.  There is
no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .ref import parallelism_search_ref

NC = 16      # CEs per design: the kernel's compile-time width

SOURCE = Path(__file__).resolve().parent / "csrc" / "parallelism_search.cu"


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


#: kernel launches since the last ``reset_launches()``, by kernel name.
#: Only the kernel wrapper adds to it, once per launch.
_LAUNCHES = {"parallelism_search": 0}


def launches() -> dict[str, int]:
    """Kernel launches counted since the last :func:`reset_launches`."""
    return dict(_LAUNCHES)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


_BUILT = None


def library():
    """The kernel library, built at the first call (an ``_nvcc.Built``
    record: the loaded library, its path, build seconds, ptxas report),
    with its C signature declared."""
    global _BUILT
    if _BUILT is None:
        from .._nvcc import load
        built = load(SOURCE)
        fn = built.lib.mccm_parallelism_search
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BUILT = built
    return _BUILT


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
    built = library()
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
