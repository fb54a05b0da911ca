"""Dispatch for the conv_ce kernel, its launch plan, and the Eq. 1 cycle
count its grid realizes.

The tensor's device picks the route: a CPU tensor runs the plain PyTorch
version (``ref.conv_ce_ref``), a CUDA tensor launches the hand-written
kernel (``csrc/conv_ce.cu``) or raises.  There is no fallback from the card
to the plain version.

The grid is fixed by Eq. 1: one block per ⟨par_f, par_oh, par_ow⟩ output
tile.  :func:`launch_plan` chooses how a block computes its tile: each
thread's register tile of outputs, the thread count, the channel chunk
staged in shared memory per step of the pipeline, the pitches of the
staged rows and how the weights are copied.  The kernel checks the plan
and refuses one it cannot run.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from ...gpu import op_walk
from .. import _LAUNCHES
from .ref import conv_ce_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "conv_ce.cu"

#: CUDA's limit on gridDim.y and gridDim.z
MAX_GRID_YZ = 65535
MAX_THREADS = 1024
#: dynamic shared memory a block may have, and an SM's (H100: 227 KB and
#: 228 KB, of which 1 KB a resident block keeps for itself)
MAX_SMEM = 232_448
SM_SMEM = 233_472
SMEM_PER_BLOCK = 1024
#: an H100 SXM's SMs, resident warps and blocks per SM, warp schedulers
SMS, SM_WARPS, SM_BLOCKS, SCHEDULERS = 132, 64, 32, 4

#: the register tiles (filters, rows, columns of outputs a thread owns)
#: the kernel is built for: ``CONV_CE_TILES`` in ``csrc/conv_ce.cu``; each
#: is the plan's choice for some Builder tile of ResNet-50, MobileNetV2 or
#: VGG-16 (``tests/test_torch_conv_ce.py``)
REGISTER_TILES = (
    (1, 1, 1), (1, 1, 2), (1, 1, 4), (1, 2, 2),
    (2, 1, 1), (2, 1, 2), (2, 1, 4), (2, 2, 2),
    (4, 1, 1), (4, 1, 2),
    (8, 1, 1), (8, 1, 2), (8, 2, 1))

#: the plan's cost model, in instructions of one (c, kh, kw) step: loop
#: and address overhead, a thread's copy of a staged weight and of a
#: staged input, and the cycles a warp waits on a shared-memory load it
#: cannot hide; set so that on ResNet-50's layers under the Builder's
#: tiles the model picks register tiles near the fastest on an H100
STEP_OVERHEAD, W_COPY, X_COPY, LOAD_LATENCY = 1, 1, 1, 60
#: (c, kh, kw) steps a chunk should hold, to spread one barrier
CHUNK_STEPS = 256
#: how a chunk's weights reach shared memory (``kCopy*`` in the source): a
#: thread an element (bf16, or f32 runs off a 16-byte boundary), or a
#: thread 16 bytes
COPY_ELEMENT, COPY_16 = 0, 1

#: the C entry point's refusals (negative returns)
_REFUSALS = {-1: "bad shape or grid", -2: "no such register tile",
             -3: "bad thread count", -4: "bad channel chunk",
             -5: "bad row pitch", -6: "bad shared-memory size",
             -7: "bad weight copy"}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_BUILT = None
_LAST = None


def max_threads(tile) -> int:
    """Threads a block of register tile ``tile`` may have: a thread of
    more than 4 outputs gets up to 128 registers, so at most 512 threads
    (``max_threads`` in ``csrc/conv_ce.cu``)."""
    return 512 if tile[0] * tile[1] * tile[2] > 4 else MAX_THREADS


@dataclass(frozen=True)
class Plan:
    """How one block computes its tile (see ``csrc/conv_ce.cu``)."""

    rf: int             # register tile: filters,
    rh: int             # output rows
    rw: int             # and output columns a thread owns
    tf: int             # thread groups along filters,
    th: int             # rows
    tw: int             # and columns
    threads: int        # whole warps, >= tf*th*tw
    cc: int             # channels a chunk stages
    wh: int             # input window rows,
    ww: int             # columns,
    wq: int             # columns of one stride phase
    row_pitch: int      # floats between window rows
    f_pitch: int        # floats between staged weight rows
    smem_bytes: int     # two stages of weights and window, step table
    w_copy: int         # COPY_ELEMENT or COPY_16
    grid: tuple         # Eq. 1's (ceil(F/pf), ceil(OH/ph), ceil(OW/pw))

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class Launch:
    """A launch as the library reports it: the grid it launched, the plan."""

    grid: tuple
    plan: Plan


def library():
    """The kernel library, built at the first call (an ``_nvcc.Built``
    record), with its C signature declared."""
    global _BUILT
    if _BUILT is None:
        from .._nvcc import load
        built = load(SOURCE)
        built.lib.conv_ce.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 20 + [ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_void_p]
        built.lib.conv_ce.restype = ctypes.c_int
        _BUILT = built
    return _BUILT


def last_launch() -> Launch | None:
    """The most recent kernel launch of this process, as reported by the
    library (None before the first)."""
    return _LAST


def grid_size(F: int, OH: int, OW: int, par_f: int, par_oh: int,
              par_ow: int) -> int:
    """Blocks of the kernel's launch grid: one per output tile."""
    return (-(-F // par_f)) * (-(-OH // par_oh)) * (-(-OW // par_ow))


def predicted_cycles(F: int, C: int, KH: int, KW: int, OH: int, OW: int,
                     par_f: int, par_oh: int, par_ow: int) -> int:
    """Eq. 1: prod_d ceil(|d|/Par(d)) — with C, KH, KW unparallelized this
    is the kernel's grid size × its inner-loop trip count."""
    return grid_size(F, OH, OW, par_f, par_oh, par_ow) * C * KH * KW


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _step_cycles(tile, ef, eh, ew, stride, KH, KW, blocks, w_copy):
    """The cost model: SM cycles of one (c, kh, kw) step of the layer on the
    busiest SM under register tile ``tile``, or None if it needs more
    threads than the tile's kernel may have.  The larger of the schedulers'
    issue (two FP32 issues a MAC, the shared-memory loads, the step's
    overhead, the staging copies), the shared-memory wavefronts, and the
    latency of a warp's step times the rounds of resident blocks."""
    rf, rh, rw = tile
    tf, th, tw = _cdiv(ef, rf), _cdiv(eh, rh), _cdiv(ew, rw)
    warps = _cdiv(tf * th * tw, 32)
    if warps * 32 > max_threads(tile):
        return None
    loads = 1 + rh * rw + _cdiv(rf, 4)
    instr = 2 * rf * rh * rw + loads + rh * rw + STEP_OVERHEAD
    window = ((th * rh - 1) * stride + KH) * ((tw * rw - 1) * stride + KW)
    w_units = tf * rf if w_copy == COPY_ELEMENT else _cdiv(tf * rf, 4)
    copies = (window * X_COPY / (KH * KW) + w_units * W_COPY) / 32
    per_sm = _cdiv(blocks, SMS)
    resident = max(1, min(SM_BLOCKS, SM_WARPS // warps, per_sm))
    issue = per_sm * (warps * instr + copies) / SCHEDULERS
    wavefronts = per_sm * warps * loads
    latency = _cdiv(per_sm, resident) * (instr + LOAD_LATENCY)
    return max(issue, wavefronts, latency)


def _row_pitch(tf, th, tw, stride, least):
    """The window's row pitch (>= ``least`` floats, < least + 32) at which
    the inputs one load of a warp reads, (gh*stride)*pitch + gw over its
    threads, fall on the fewest words per bank."""
    t = np.arange(tf * th * tw)
    gw, gh = t % tw, (t // tw) % th
    warps = _cdiv(t.size, 32)
    key = np.full(warps * 32, -1)
    key[:t.size] = gh * tw + gw
    key = key.reshape(warps, 32)
    # threads of one warp that read the same word are one access
    first = np.zeros_like(key, dtype=bool)
    for i, row in enumerate(key):
        _, idx = np.unique(row, return_index=True)
        first[i, idx] = True
    first &= key >= 0
    gh_w, gw_w = key // tw, key % tw
    pitches = np.arange(least, least + 32)
    addr = (gh_w[None] * stride * pitches[:, None, None] + gw_w[None])
    banks = np.where(first[None], addr % 32, -1)
    counts = (banks[..., None] == np.arange(32)).sum(axis=2)  # (P, warps, 32)
    worst = counts.max(axis=2)                                 # (P, warps)
    return int(pitches[np.lexsort((worst.sum(axis=1),
                                   worst.max(axis=1)))[0]])


@functools.lru_cache(maxsize=8192)
def launch_plan(C: int, H: int, W: int, F: int, KH: int, KW: int,
                stride: int, par_f: int, par_oh: int, par_ow: int,
                bf16: bool = False) -> Plan:
    """The launch plan of one layer on the CE with tile ⟨par_f, par_oh,
    par_ow⟩, for f32 inputs or (``bf16``) bfloat16 ones.

    The register tile is the one of ``REGISTER_TILES`` that the cost model
    (:func:`_step_cycles`) rates fastest for the tile's part that exists,
    ⟨min(par_f, F), min(par_oh, OH), min(par_ow, OW)⟩, and the layer's
    grid.  The chunk holds about ``CHUNK_STEPS`` (c, kh, kw) steps, at
    most half the channels (so the next chunk's copy overlaps this one's
    work) and as many as two stages of the shared memory the block's share
    of an SM holds.  Aligned f32 weights are copied 16 bytes a thread,
    bf16 or unaligned ones an element a thread.  Raises ``ValueError``
    where no plan fits: a tile larger than any register tile's block
    holds, or an input window or weight block whose two stages of one
    channel pass 227 KB.
    """
    if min(C, F, KH, KW, stride, par_f, par_oh, par_ow) < 1 \
            or H < KH or W < KW:
        raise ValueError(f"empty input, kernel larger than the input, or "
                         f"stride/tile < 1: x ({C}, {H}, {W}), w ({F}, {C}, "
                         f"{KH}, {KW}), stride {stride}, tile ({par_f}, "
                         f"{par_oh}, {par_ow})")
    OH = (H - KH) // stride + 1
    OW = (W - KW) // stride + 1
    grid = (_cdiv(F, par_f), _cdiv(OH, par_oh), _cdiv(OW, par_ow))
    if grid[1] > MAX_GRID_YZ or grid[2] > MAX_GRID_YZ:
        raise ValueError(f"launch grid {grid} passes CUDA's limit of "
                         f"{MAX_GRID_YZ} on y and z")
    ef, eh, ew = min(par_f, F), min(par_oh, OH), min(par_ow, OW)
    kk = KH * KW
    blocks = grid[0] * grid[1] * grid[2]
    aligned = not bf16 and F % 4 == 0 and (par_f % 4 == 0 or grid[0] == 1)
    w_copy = COPY_16 if aligned else COPY_ELEMENT
    # fastest, then the fewest outputs computed past the tile's edge
    rated = [(c, _cdiv(ef, t[0]) * t[0] * _cdiv(eh, t[1]) * t[1]
              * _cdiv(ew, t[2]) * t[2], t) for t in REGISTER_TILES
             if (c := _step_cycles(t, ef, eh, ew, stride, KH, KW, blocks,
                                   w_copy)) is not None]
    if not rated:
        most = max(max_threads(t) * t[0] * t[1] * t[2]
                   for t in REGISTER_TILES)
        raise ValueError(f"tile ({par_f}, {par_oh}, {par_ow}): no block of "
                         f"the kernel's register tiles holds it (at most "
                         f"{most} outputs)")
    rf, rh, rw = min(rated)[2]
    tf, th, tw = _cdiv(ef, rf), _cdiv(eh, rh), _cdiv(ew, rw)
    threads = _cdiv(tf * th * tw, 32) * 32
    wh = (th * rh - 1) * stride + KH
    ww = (tw * rw - 1) * stride + KW
    wq = _cdiv(ww, stride)
    row_pitch = _row_pitch(tf, th, tw, stride, stride * wq)
    f_pitch = _cdiv(tf * rf, 4) * 4
    per_channel = 4 * (2 * (kk * f_pitch + wh * row_pitch) + kk)
    resident = max(1, min(SM_BLOCKS, SM_WARPS // (threads // 32),
                          _cdiv(blocks, SMS)))
    budget = min(MAX_SMEM, SM_SMEM // resident - SMEM_PER_BLOCK)
    cc = max(1, min(C, _cdiv(CHUNK_STEPS, kk), _cdiv(C, 2),
                    budget // per_channel))
    stage = _cdiv(cc * (kk * f_pitch + wh * row_pitch), 4) * 4
    # two stages and the step table
    smem = 4 * (2 * stage + cc * kk)
    if smem > MAX_SMEM:
        raise ValueError(f"tile ({par_f}, {par_oh}, {par_ow}) of a "
                         f"{KH}x{KW} stride-{stride} layer: two stages of "
                         f"one channel take {smem} bytes of shared memory, "
                         f"more than {MAX_SMEM}")
    return Plan(rf, rh, rw, tf, th, tw, threads, cc, wh, ww, wq, row_pitch,
                f_pitch, smem, w_copy, grid)


def conv_ce_cuda(x, w, *, stride: int = 1, par_f: int = 8, par_oh: int = 4,
                 par_ow: int = 4):
    """Launch the kernel on the current stream.

    x (C, H, W) and w (F, C, KH, KW), both float32 or both bfloat16, on one
    CUDA device; valid padding.  Returns (F, OH, OW) in ``x.dtype``, equal
    to ``conv_ce_ref`` on the same inputs bit for bit.  The library call
    transposes w into a scratch tensor allocated here, then launches the
    CE kernel on Eq. 1's grid: one launch in the count.  The launch, with
    the grid the library reports, is :func:`last_launch`.
    """
    global _LAST
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
    plan = launch_plan(C, H, W, F, KH, KW, stride, par_f, par_oh, par_ow,
                       x.dtype == torch.bfloat16)
    OH = (H - KH) // stride + 1
    OW = (W - KW) // stride + 1
    x, w = x.contiguous(), w.contiguous()
    out = torch.empty(F, OH, OW, dtype=x.dtype, device=x.device)
    wt = torch.empty(C * KH * KW, F, dtype=x.dtype, device=x.device)
    grid = (ctypes.c_int * 3)()
    built = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = built.lib.conv_ce(
            x.data_ptr(), w.data_ptr(), wt.data_ptr(), out.data_ptr(), C, H,
            W, F, KH, KW,
            stride, par_f, par_oh, par_ow, _DTYPES[x.dtype], plan.rf,
            plan.rh, plan.rw, plan.threads, plan.cc, plan.row_pitch,
            plan.f_pitch, plan.smem_bytes, plan.w_copy, grid, stream)
    if err < 0:
        raise RuntimeError(f"conv_ce refused its launch plan "
                           f"({_REFUSALS.get(err, err)}): {plan}")
    if err != 0:
        raise RuntimeError(f"conv_ce kernel launch failed: CUDA error {err}")
    _LAUNCHES["conv_ce"] += 1
    _LAST = Launch(tuple(grid), plan)
    return out


def cost(C: int, H: int, W: int, F: int, KH: int, KW: int, stride: int,
         dtype) -> dict:
    """The work of one valid convolution of x (C, H, W) by w (F, C, KH,
    KW), the kernel's and its bound's: 2 operations a MAC, and x and w
    read and the (F, OH, OW) output written once each."""
    OH = (H - KH) // stride + 1
    OW = (W - KW) // stride + 1
    elt = torch.empty((), dtype=dtype).element_size()
    return dict(flops=2 * F * OH * OW * C * KH * KW, transcendentals=0,
                bytes=elt * (C * H * W + F * C * KH * KW + F * OH * OW),
                dtype=dtype)


def conv_ce(x, w, *, stride: int = 1, par_f: int = 8, par_oh: int = 4,
            par_ow: int = 4):
    """One layer on a CE with parallelism ⟨par_f, par_oh, par_ow⟩, routed
    by the tensors' device.

    x (C, H, W); w (F, C, KH, KW) -> (F, OH, OW) valid conv in ``x.dtype``.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel,
    whose grid is ``(⌈F/par_f⌉, ⌈OH/par_oh⌉, ⌈OW/par_ow⌉)``, and an error
    there propagates.  The JAX package's ``interpret`` flag (its CPU
    interpreter) has no counterpart: the CPU runs the plain version.
    Inside an ``op_walk.OpWalk`` either route is charged :func:`cost` as
    ``conv_ce``.
    """
    with op_walk.charge("conv_ce", lambda: cost(
            *x.shape, w.shape[0], *w.shape[2:], stride, x.dtype)):
        if x.device.type == "cuda":
            return conv_ce_cuda(x, w, stride=stride, par_f=par_f,
                                par_oh=par_oh, par_ow=par_ow)
        if x.device.type != "cpu":
            raise ValueError(f"no conv_ce route for a tensor on {x.device}; "
                             f"use a CPU or CUDA tensor")
        return conv_ce_ref(x, w, stride=stride, par_f=par_f, par_oh=par_oh,
                           par_ow=par_ow)
