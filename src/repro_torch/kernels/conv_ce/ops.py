"""Dispatch for the conv_ce kernel, and the Eq. 1 cycle count its grid
realizes.

The tensor's device picks the route: a CPU tensor runs the plain PyTorch
version (``ref.conv_ce_ref``), a CUDA tensor launches the hand-written
kernel (``csrc/conv_ce.cu``) or raises.  There is no fallback from the card
to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import _LAUNCHES
from .ref import conv_ce_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "conv_ce.cu"

#: CUDA's limit on gridDim.y and gridDim.z
MAX_GRID_YZ = 65535

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_BUILT = None


def library():
    """The kernel library, built at the first call (an ``_nvcc.Built``
    record), with its C signature declared."""
    global _BUILT
    if _BUILT is None:
        from .._nvcc import load
        built = load(SOURCE)
        built.lib.conv_ce.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        built.lib.conv_ce.restype = ctypes.c_int
        _BUILT = built
    return _BUILT


def grid_size(F: int, OH: int, OW: int, par_f: int, par_oh: int,
              par_ow: int) -> int:
    """Blocks of the kernel's launch grid: one per output tile."""
    return (-(-F // par_f)) * (-(-OH // par_oh)) * (-(-OW // par_ow))


def predicted_cycles(F: int, C: int, KH: int, KW: int, OH: int, OW: int,
                     par_f: int, par_oh: int, par_ow: int) -> int:
    """Eq. 1: prod_d ceil(|d|/Par(d)) — with C, KH, KW unparallelized this
    is the kernel's grid size × its inner-loop trip count."""
    return grid_size(F, OH, OW, par_f, par_oh, par_ow) * C * KH * KW


def conv_ce_cuda(x, w, *, stride: int = 1, par_f: int = 8, par_oh: int = 4,
                 par_ow: int = 4):
    """Launch the kernel on the current stream.

    x (C, H, W) and w (F, C, KH, KW), both float32 or both bfloat16, on one
    CUDA device; valid padding.  Returns (F, OH, OW) in ``x.dtype``, equal
    to ``conv_ce_ref`` on the same inputs bit for bit.
    """
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x is on {x.device}, w on {w.device}; both must "
                         f"be on one CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or both bfloat16, "
                        f"got {x.dtype} and {w.dtype}")
    if x.dim() != 3 or w.dim() != 4 or w.shape[1] != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} / w {tuple(w.shape)} must be "
                         f"(C, H, W) / (F, C, KH, KW)")
    C, H, W = x.shape
    F, _, KH, KW = w.shape
    if min(C, F, KH, KW, stride, par_f, par_oh, par_ow) < 1 \
            or H < KH or W < KW:
        raise ValueError(f"empty input, kernel larger than the input, or "
                         f"stride/tile < 1: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, stride {stride}, tile "
                         f"({par_f}, {par_oh}, {par_ow})")
    OH = (H - KH) // stride + 1
    OW = (W - KW) // stride + 1
    if -(-OH // par_oh) > MAX_GRID_YZ or -(-OW // par_ow) > MAX_GRID_YZ:
        raise ValueError(f"launch grid ({-(-F // par_f)}, "
                         f"{-(-OH // par_oh)}, {-(-OW // par_ow)}) passes "
                         f"CUDA's limit of {MAX_GRID_YZ} on y and z")
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty(F, OH, OW, dtype=x.dtype, device=x.device)
    built = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = built.lib.conv_ce(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                C, H, W, F, KH, KW, stride, par_f, par_oh,
                                par_ow, _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv_ce kernel launch failed: CUDA error {err}")
    _LAUNCHES["conv_ce"] += 1
    return out


def conv_ce(x, w, *, stride: int = 1, par_f: int = 8, par_oh: int = 4,
            par_ow: int = 4):
    """One layer on a CE with parallelism ⟨par_f, par_oh, par_ow⟩, routed
    by the tensors' device.

    x (C, H, W); w (F, C, KH, KW) -> (F, OH, OW) valid conv in ``x.dtype``.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel,
    whose grid is ``(⌈F/par_f⌉, ⌈OH/par_oh⌉, ⌈OW/par_ow⌉)``, and an error
    there propagates.  The JAX package's ``interpret`` flag (its CPU
    interpreter) has no counterpart: the CPU runs the plain version.
    """
    if x.device.type == "cuda":
        return conv_ce_cuda(x, w, stride=stride, par_f=par_f, par_oh=par_oh,
                            par_ow=par_ow)
    if x.device.type != "cpu":
        raise ValueError(f"no conv_ce route for a tensor on {x.device}; use "
                         f"a CPU or CUDA tensor")
    return conv_ce_ref(x, w, stride=stride, par_f=par_f, par_oh=par_oh,
                       par_ow=par_ow)
