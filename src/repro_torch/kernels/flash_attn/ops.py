"""Dispatch for the flash-attention kernel.

The tensor's device picks the route: a CPU tensor runs the plain PyTorch
version (``ref.flash_fwd_ref``), a CUDA tensor launches the hand-written
kernel (``csrc/flash_fwd.cu``) or raises.  There is no fallback from the
card to the plain version.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import _LAUNCHES
from .ref import flash_fwd_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_fwd.cu"

#: CUDA's limit on gridDim.y, which counts batch x query heads
MAX_GRID_Y = 65535
#: head dims the kernel is instantiated for
HEAD_DIMS = tuple(range(16, 129, 16))

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_BUILT = None


def library():
    """The kernel library, built at the first call (an ``_nvcc.Built``
    record), with its C signature declared."""
    global _BUILT
    if _BUILT is None:
        from .._nvcc import load
        built = load(SOURCE)
        built.lib.flash_fwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        built.lib.flash_fwd.restype = ctypes.c_int
        _BUILT = built
    return _BUILT


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


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         scale: float | None = None, q_offset: int = 0):
    """Launch the kernel on the current stream.

    q (B, Sq, H, D), k/v (B, Sk, Hkv, D), all float32 or all bfloat16 on
    one CUDA device, each with its last dim contiguous (other strides are
    read as they are); D a multiple of 16 up to 128.  Returns a contiguous
    (B, Sq, H, D) in q's dtype, equal to ``flash_fwd_ref`` within the
    rounding of f32 sums taken in another order.
    """
    _check(q, k, v, window)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}: all must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    if B * H > MAX_GRID_Y:
        raise ValueError(f"B x H = {B * H} passes CUDA's grid limit of "
                         f"{MAX_GRID_Y}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty(B, Sq, H, D, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    built = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = built.lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, H, Hkv, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), int(window is not None),
            window or 0, q_offset, scale, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    _LAUNCHES["flash_fwd"] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None, scale: float | None = None,
                    q_offset: int = 0):
    """Flash-attention forward, routed by the tensors' device.

    q (B, Sq, H, D); k/v (B, Sk, Hkv, D), GQA heads read in place -> (B, Sq,
    H, D) in q's dtype.  A CPU tensor runs the plain recurrence
    (``flash_fwd_ref``); a CUDA tensor launches the kernel, and an error
    there propagates.  The JAX package's block sizes and ``interpret`` flag
    have no counterpart: the kernel's tiles are fixed, and the CPU runs the
    plain version.
    """
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale, q_offset=q_offset)
    if q.device.type != "cpu":
        raise ValueError(f"no flash_attention route for a tensor on "
                         f"{q.device}; use a CPU or CUDA tensor")
    _check(q, k, v, window)
    return flash_fwd_ref(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)
