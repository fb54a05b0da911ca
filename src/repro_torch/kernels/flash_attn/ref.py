"""Plain PyTorch versions of the flash-attention kernel.

* :func:`attention_ref` is a copy of the JAX package's oracle
  (``kernels/flash_attn/ref.py``): materialised f32 scores, layout
  (B, H, S, D), fully masked rows give zeros.
* :func:`flash_fwd_ref` is the kernel's twin and its CPU route: the
  online-softmax recurrence of the Pallas kernel's body
  (``kernels/flash_attn/kernel.py::_flash_fwd_kernel``) over KV tiles of
  ``KV_TILE`` keys, in the public layout q (B, Sq, H, D), k/v
  (B, Sk, Hkv, D).  Its arithmetic is the kernel's (``csrc/flash_fwd.cu``):
  q·scale in f32, f32 scores, the ``-inf``-safe running max, ``p`` kept in
  f32 for p·v with an f32 accumulator, ``l == 0 -> 1``, the result in q's
  dtype.  Only the summation order of the two products differs, so the
  two agree to :data:`TOLERANCE`, not bit for bit.

  ``p`` stays f32 because the Pallas body widens v to f32 before its
  ``p.astype(v.dtype)``.  In bf16 this differs from the JAX model code's
  jnp twin (``models/layers.py::chunked_attention``) and from the oracle
  ``attention_ref``, which both round p (or p / l) to bf16.
"""
from __future__ import annotations

import math

import torch

#: keys per KV tile of the kernel, and of its twin's recurrence
KV_TILE = 64

#: the kernel against :func:`flash_fwd_ref`, element by element:
#: |got - want| <= rtol·|want| + atol.  The two take f32 sums of the same
#: terms in other orders, so their f32 results part by a few f32 ulps
#: (about 1e-6 at unit scale; ``atol`` is the JAX package's f32 flash
#: tolerance, tests/test_kernels.py:37).  In bf16 both then round to bf16,
#: and a sum on the other side of a rounding boundary moves one bf16 ulp,
#: at most 2**-7·|want|.
TOLERANCE = {torch.float32: (0.0, 2e-5), torch.bfloat16: (2.0 ** -7, 2e-5)}


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None):
    """Materialised-scores attention.  q: (B, H, Sq, D); k/v: (B, H, Sk, D).

    fp32 softmax; masked rows return zeros (matching the kernel)."""
    Sq, D = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    mask = attention_mask(torch.arange(Sq, device=q.device),
                          torch.arange(Sk, device=q.device), Sk, causal,
                          window)
    s = torch.where(mask, s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = (p / l).to(v.dtype).float() @ v.float()
    return out.to(q.dtype)


def excess(got, want) -> float:
    """The largest |got - want| - (rtol·|want| + atol) over the elements,
    at want's dtype's :data:`TOLERANCE`: <= 0 where got meets want."""
    rtol, atol = TOLERANCE[want.dtype]
    w = want.float()
    return float(((got.float() - w).abs() - rtol * w.abs() - atol).max())


def attention_mask(q_abs, k_abs, sk_real: int, causal: bool,
                   window: int | None):
    """(Sq, Sk) bool validity of each (query, key) pair, from the queries'
    and keys' absolute positions: keys at or past ``sk_real`` are padding,
    ``causal`` hides later keys, ``window`` keys more than ``window - 1``
    positions back."""
    msk = (k_abs < sk_real)[None, :].expand(len(q_abs), len(k_abs))
    if causal:
        msk = msk & (k_abs[None, :] <= q_abs[:, None])
    if window is not None:
        msk = msk & (k_abs[None, :] > q_abs[:, None] - window)
    return msk


def kv_range(Sq: int, Sk: int, *, causal: bool, window: int | None,
             q_offset: int = 0) -> tuple[int, int]:
    """Keys [lo, hi) that any of the queries q_offset .. q_offset + Sq - 1
    may see.  A KV tile outside it is masked for every query, and skipping
    it leaves the recurrence's state exactly as it was (its ``p`` are 0,
    its ``alpha`` is 1, or 0 on a zero state), so the kernel and its twin
    skip it."""
    hi = min(Sk, Sq + q_offset) if causal else Sk
    lo = max(0, q_offset - window + 1) if window is not None else 0
    return lo, max(lo, hi)


def flash_fwd_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None, q_offset: int = 0):
    """Flash-attention forward, the online-softmax recurrence over KV tiles.

    q (B, Sq, H, D); k/v (B, Sk, Hkv, D) with H a multiple of Hkv: query
    head h reads KV head h // (H / Hkv), never a repeated copy.  Query i
    sits at absolute position ``q_offset + i``.  Returns (B, Sq, H, D) in
    q's dtype; a row that no key may see gives 0.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"{H} query heads is not a multiple of {Hkv} KV "
                         f"heads")
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    # (B, Hkv, rep, Sq, D): query heads grouped under their KV head
    qs = q.float().mul(scale).permute(0, 2, 1, 3).reshape(B, Hkv, rep, Sq, D)
    kf = k.permute(0, 2, 1, 3)[:, :, None]                 # (B, Hkv, 1, Sk, D)
    vf = v.permute(0, 2, 1, 3)[:, :, None]
    q_abs = torch.arange(Sq, device=dev) + q_offset
    acc = torch.zeros(B, Hkv, rep, Sq, D, dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, rep, Sq), -torch.inf, device=dev)
    l = torch.zeros(B, Hkv, rep, Sq, device=dev)
    lo, hi = kv_range(Sq, Sk, causal=causal, window=window,
                      q_offset=q_offset)
    for k0 in range(lo // KV_TILE * KV_TILE, hi, KV_TILE):
        k1 = min(k0 + KV_TILE, Sk)
        s = qs @ kf[..., k0:k1, :].float().transpose(-1, -2)
        msk = attention_mask(q_abs, torch.arange(k0, k1, device=dev), Sk,
                             causal, window)
        s = torch.where(msk, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.where(msk, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vf[..., k0:k1, :].float()
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).to(q.dtype)
    return out.reshape(B, H, Sq, D).permute(0, 2, 1, 3)
