"""Dispatch for the flash-attention kernels.

The tensor's device picks the route: a CPU tensor runs the plain PyTorch
version (``ref.flash_fwd_ref``), a CUDA tensor launches a hand-written
kernel or raises.  There is no fallback from the card to the plain version.
The dtype picks the kernel: bf16 runs on the tensor cores
(``csrc/flash_fwd_bf16.cu``: wgmma fed by TMA), f32 on the FMA units
(``csrc/flash_fwd.cu``: 8 x 8 register tiles a thread fed by a
``cp.async`` K/V ring).  Both count as ``flash_fwd`` launches.  Each
kernel reports its launch plan (:func:`launch_plan`); :func:`f32_plan` is
the f32 kernel's plan worked out in plain Python, which the CPU tests hold
to the card's limits.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import numpy as np
import torch

from ...gpu import op_walk
from .. import _COPIES, _LAUNCHES
from .ref import flash_fwd_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
#: the kernel source of each dtype, and its C entry point
SOURCES = {torch.float32: _CSRC / "flash_fwd.cu",
           torch.bfloat16: _CSRC / "flash_fwd_bf16.cu"}
_ENTRY = {torch.float32: "flash_fwd", torch.bfloat16: "flash_fwd_bf16"}
_PLAN_ENTRY = {torch.float32: "flash_fwd_f32_plan",
               torch.bfloat16: "flash_fwd_bf16_plan"}

#: CUDA's limit on gridDim.y, which counts the bf16 kernel's tiles of query
#: rows
MAX_GRID_Y = 65535
#: CUDA's limit on gridDim.x, which counts every CTA of the f32 kernel
MAX_GRID_X = 2 ** 31 - 1
#: query rows a CTA of each kernel takes (BQ in its source)
BF16_ROWS = F32_ROWS = 128
#: head dims the kernels are instantiated for
HEAD_DIMS = tuple(range(16, 129, 16))
#: an H100's shared memory an SM, and what the runtime keeps back for each
#: resident CTA
SM_SHARED_BYTES = 233_472
CTA_RESERVED_BYTES = 1024
#: the keys of a launch plan, in the order the C entries report them
PLAN_KEYS = ("threads", "rows", "keys", "stages", "smem_bytes",
             "ctas_per_sm")
F32_PLAN_KEYS = PLAN_KEYS + ("max_ctas",)

_BUILT: dict = {}


def library(dtype):
    """The kernel library of ``dtype`` (float32 or bfloat16), built at its
    first call (an ``_nvcc.Built`` record), with its C signatures
    declared."""
    built = _BUILT.get(dtype)
    if built is None:
        from .._nvcc import load
        built = load(SOURCES[dtype])
        fn = getattr(built.lib, _ENTRY[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        plan = getattr(built.lib, _PLAN_ENTRY[dtype])
        plan.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        plan.restype = ctypes.c_int
        _BUILT[dtype] = built
    return built


def launch_plan(D: int, dtype) -> dict:
    """The CTA a launch of ``dtype``'s kernel at head dim ``D`` takes, as
    the kernel reports it: threads, query rows, keys a tile, stages of the
    K/V ring, dynamic shared-memory bytes, and the CTAs an SM its launch
    bound allows for; the f32 kernel adds the most CTAs its one-dimensional
    grid may have (``max_ctas``)."""
    keys = F32_PLAN_KEYS if dtype == torch.float32 else PLAN_KEYS
    plan = (ctypes.c_int * len(keys))()
    if getattr(library(dtype).lib, _PLAN_ENTRY[dtype])(D, plan) != 0:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    return dict(zip(keys, plan))


def f32_plan(D: int) -> dict:
    """The f32 kernel's launch plan at head dim ``D``, worked out as
    ``csrc/flash_fwd.cu`` works it out: 128 threads, each 8 query rows of
    the CTA's 128 and 8 keys of a 64-key tile (4 of a 32-key tile for D >
    64); shared memory for q·scale (D x 128), a 32-key chunk of p (rows
    padded to 132) and two stages of K (rows padded by 4 floats unless
    D / 4 is a multiple of 8) and V; two CTAs an SM where two fit in its
    shared memory with their reserves."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    threads, stages, p_keys = 128, 2, 32
    keys = 64 if D <= 64 else 32
    k_stride = D if (D // 4) % 8 == 0 else D + 4
    smem = 4 * (D * F32_ROWS + p_keys * (F32_ROWS + 4)
                + stages * keys * (k_stride + D))
    ctas = 2 if 2 * (smem + CTA_RESERVED_BYTES) <= SM_SHARED_BYTES else 1
    return dict(zip(F32_PLAN_KEYS, (threads, F32_ROWS, keys, stages, smem,
                                    ctas, MAX_GRID_X)))


def f32_ctas(B: int, Sq: int, H: int) -> int:
    """CTAs of an f32 launch: one per (tile of 128 query rows, batch, query
    head), on a one-dimensional grid."""
    return -(-Sq // F32_ROWS) * B * H


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must be (B, Sq, H, D) and two "
                         f"equal (B, Sk, Hkv, D)")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[2] < 1 \
            or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim, or {H} query heads is not "
                         f"a multiple of {k.shape[2]} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def readable(t) -> bool:
    """Whether the kernel of ``t``'s dtype reads ``t`` (B, S, heads, D) as
    it is.  Both read rows in 16-byte pieces (the bf16 kernel by TMA, the
    f32 kernel by ``cp.async`` and float4 loads), so both need the head dim
    contiguous, a 16-byte aligned base and, for each other dim longer than
    1, a stride that is a positive multiple of 16 bytes (8 bf16 or 4 f32
    elements).  A contiguous tensor, and a head-dim slice of a fused
    projection, meet them."""
    if t.stride(-1) != 1:
        return False
    per16 = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st > 0 and st % per16 == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _strides(t) -> list[int]:
    """(batch, sequence, head) element strides; a dim of length 1 is never
    stepped along and takes the contiguous stride, which TMA accepts."""
    B, S, Hs, D = t.shape
    packed = (S * Hs * D, Hs * D, D)
    return [st if n > 1 else p
            for n, st, p in zip(t.shape[:3], t.stride()[:3], packed)]


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         scale: float | None = None, q_offset: int = 0):
    """Launch the kernel of q's dtype on the current stream.

    q (B, Sq, H, D), k/v (B, Sk, Hkv, D), all float32 or all bfloat16 on
    one CUDA device, read through their strides; D a multiple of 16 up to
    128.  Returns a contiguous (B, Sq, H, D) in q's dtype, equal to
    ``flash_fwd_ref`` within ``ref.TOLERANCE``.

    A view that the kernel cannot read as it is (see :func:`readable`) is
    copied to a contiguous tensor first, inside this call, and each such
    copy adds one to ``copies()["flash_fwd"]``.  Contiguous tensors and
    head-dim slices of a fused qkv projection are read without a copy.
    """
    _check(q, k, v, window)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}: all must be on one CUDA device")
    if q.dtype not in SOURCES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    grid, limit, axis = ((-(-Sq // BF16_ROWS), MAX_GRID_Y, "y")
                         if q.dtype == torch.bfloat16
                         else (f32_ctas(B, Sq, H), MAX_GRID_X, "x"))
    if grid > limit:
        raise ValueError(f"the launch needs a grid of {grid} along {axis}, "
                         f"past CUDA's limit of {limit}")
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    ts = []
    for t in (q, k, v):
        if not readable(t):
            t = t.contiguous()
            _COPIES["flash_fwd"] += 1
        ts.append(t)
    q, k, v = ts
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if window is not None:
        # a window past every (query, key) distance masks nothing: capped,
        # the kernels' int arithmetic on it cannot overflow
        window = min(window, Sq + Sk + abs(q_offset) + 1)
    fn = getattr(library(q.dtype).lib, _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, Hkv, D, *_strides(q), *_strides(k),
                 *_strides(v), int(causal), int(window is not None),
                 window or 0, q_offset, scale, stream)
    if err < 0:
        raise RuntimeError(f"flash_fwd: the driver refused a TMA tensor map "
                           f"(CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    _LAUNCHES["flash_fwd"] += 1
    return out


def visible_pairs(Sq: int, Sk: int, causal: bool, window: int | None,
                  q_offset: int = 0) -> int:
    """The (query, key) pairs of one (batch, head) that the masks leave
    visible: query i at position ``q_offset + i`` sees key j < Sk where
    ``causal`` allows j <= its position and ``window`` j > its position -
    window.  A sum over the queries of each one's run of keys, so it stays
    cheap at any length."""
    pos = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(Sk - 1, pos) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, pos - window + 1) if window is not None else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(B: int, Sq: int, Sk: int, H: int, Hkv: int, D: int, causal: bool,
         window: int | None, dtype, q_offset: int = 0) -> dict:
    """The work of one attention call, the kernel's and its bound's: 4·D
    operations for each visible (query, key) pair of each (batch, query
    head) (2·D for q·k, 2·D for p·v), one exp a pair, and q, k, v read and
    the output written once each."""
    pairs = visible_pairs(Sq, Sk, causal, window, q_offset) * B * H
    elt = torch.empty((), dtype=dtype).element_size()
    return dict(pairs=pairs, flops=4 * D * pairs, transcendentals=pairs,
                bytes=elt * (2 * B * Sq * H * D + 2 * B * Sk * Hkv * D),
                dtype=dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    q_offset: int = 0):
    """Flash-attention forward, routed by the tensors' device.

    q (B, Sq, H, D); k/v (B, Sk, Hkv, D), GQA heads read in place -> (B, Sq,
    H, D) in q's dtype, contiguous.  A CPU tensor runs the plain recurrence
    (``flash_fwd_ref``); a CUDA tensor launches the kernel of its dtype,
    and an error there propagates; a ``meta`` tensor (the dry-run's
    stand-ins, which hold no data) computes nothing and returns an empty
    ``meta`` tensor of the output's shape and dtype.  Any other device
    raises.  The JAX package's block sizes and ``interpret`` flag have no
    counterpart: the kernels' tiles are fixed, and the CPU runs the plain
    version.  Inside an ``op_walk.OpWalk`` every route is charged
    :func:`cost` as ``flash_fwd``.
    """
    with op_walk.charge("flash_fwd", lambda: cost(
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3], causal, window, q.dtype, q_offset)):
        if q.device.type == "cuda":
            return flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        q_offset=q_offset)
        _check(q, k, v, window)
        if q.device.type == "meta":
            return torch.empty(q.shape, dtype=q.dtype, device="meta")
        if q.device.type != "cpu":
            raise ValueError(f"no flash_attention route for a tensor on "
                             f"{q.device}; use a CPU, CUDA or meta tensor")
        # contiguous, as the kernel returns it: the callers' reshapes then
        # run the same ops on both routes
        return flash_fwd_ref(q, k, v, causal=causal, window=window,
                             scale=scale, q_offset=q_offset).contiguous()
