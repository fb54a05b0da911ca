"""Plain PyTorch versions of the conv_ce kernel (valid-padding direct conv).

Layouts are the JAX package's (``kernels/conv_ce/ref.py``): x (C, H, W), w
(F, C, KH, KW) -> (F, OH, OW), so numpy arrays pass straight across.  The
sum of each output is one f32 accumulator that adds x*w over (c, kh, kw)
in ascending order, a multiply and then an add per step: no ``conv2d`` and
no matmul, whose summation orders are their own, so the CUDA kernel
(``csrc/conv_ce.cu``), which adds in the same order, agrees bit for bit.
"""
from __future__ import annotations

import torch


def conv_ref(x, w, stride: int = 1):
    """x: (C, H, W); w: (F, C, KH, KW) -> (F, OH, OW), valid padding.

    f32 or bf16 inputs are widened to f32, accumulated in f32, and the
    result is cast back to ``x.dtype``.
    """
    C, H, W = x.shape
    F, _, KH, KW = w.shape
    OH = (H - KH) // stride + 1
    OW = (W - KW) // stride + 1
    xf, wf = x.to(torch.float32), w.to(torch.float32)
    acc = torch.zeros(F, OH, OW, dtype=torch.float32, device=x.device)
    for c in range(C):
        for kh in range(KH):
            for kw in range(KW):
                xs = xf[c, kh:kh + stride * (OH - 1) + 1:stride,
                        kw:kw + stride * (OW - 1) + 1:stride]
                acc = acc + xs[None] * wf[:, c, kh, kw][:, None, None]
    return acc.to(x.dtype)


def conv_ce_ref(x, w, *, stride: int = 1, par_f: int = 8, par_oh: int = 4,
                par_ow: int = 4):
    """The plain version of ``ops.conv_ce``: the tile ⟨par_f, par_oh,
    par_ow⟩ sets the kernel's launch grid, never the numbers, so the
    result is :func:`conv_ref`'s."""
    if min(stride, par_f, par_oh, par_ow) < 1:
        raise ValueError(f"stride and tile must be >= 1, got stride "
                         f"{stride}, tile ({par_f}, {par_oh}, {par_ow})")
    return conv_ref(x, w, stride)
