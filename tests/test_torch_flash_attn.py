"""The port's flash attention on the CPU against the JAX package.

The port's ``flash_attention`` on a CPU tensor runs its plain recurrence
(``flash_fwd_ref``), the twin of the CUDA kernel; ``attention_ref`` is the
port's copy of the JAX oracle.  Both are held against the JAX package's
``attention_ref`` and its model code's ``chunked_attention`` and
``dense_attention``, on the same inputs drawn by numpy from a seed.  The
JAX Pallas kernel itself fails on the installed jax (its ``pl.load`` is
gone), so it is not the reference here.

Tolerances against the JAX package are ``tests/test_kernels.py:37``'s:
2e-5 in f32 (sums in other orders), 5e-2 in bf16 (an output may round to
the neighbouring bf16 value, and JAX's chunked path rounds q·scale and p
to bf16 where the port, as the Pallas kernel, keeps both in f32).  Two
bf16 tests hold the port tighter: against JAX's oracle computed in f32 on
the same bf16 inputs, and on a case where rounding p to bf16 changes the
answer.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ref import attention_ref as jax_attention_ref
from repro.models import layers as JL
from repro_torch.kernels import launches, reset_launches
from repro_torch.kernels.flash_attn import (attention_ref, flash_attention,
                                            flash_attention_cuda,
                                            flash_fwd_ref)
from repro_torch.kernels.flash_attn import ops
from repro_torch.kernels.flash_attn.ref import (KV_TILE, attention_mask,
                                                excess, kv_range)

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _inputs(B, Sq, Sk, H, Hkv, D, dtype, seed=0):
    """q (B, Sq, H, D), k/v (B, Sk, Hkv, D) as numpy f32 (already rounded
    to ``dtype``), and the same as JAX and torch arrays of ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, th


def _close(got, want, dtype, what=""):
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=what)


# the five cases of tests/test_kernels.py:18-24
KERNEL_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, "float32"),
    (1, 200, 200, 2, 2, 32, True, 64, "float32"),
    (2, 64, 256, 4, 4, 64, False, None, "float32"),
    (1, 1, 300, 4, 2, 64, False, None, "float32"),      # decode-like
    (2, 96, 96, 2, 1, 128, True, None, "bfloat16"),
]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,dtype",
                         KERNEL_CASES)
def test_flash_attention_vs_jax_attention_ref(B, Sq, Sk, H, Hkv, D, causal,
                                              window, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, H, Hkv, D, dtype)
    rep = H // Hkv
    want = jax_attention_ref(
        jq.transpose(0, 2, 1, 3), jnp.repeat(jk, rep, 2).transpose(0, 2, 1, 3),
        jnp.repeat(jv, rep, 2).transpose(0, 2, 1, 3), causal=causal,
        window=window).transpose(0, 2, 1, 3)
    reset_launches()
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert launches()["flash_fwd"] == 0       # the CPU runs the plain twin
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, dtype, "flash_attention")
    # the port's own oracle, on the repeated heads
    kk, vv = (t.repeat_interleave(rep, 2) for t in (k, v))
    mine = attention_ref(q.transpose(1, 2), kk.transpose(1, 2),
                         vv.transpose(1, 2), causal=causal,
                         window=window).transpose(1, 2)
    _close(mine, want, dtype, "attention_ref")


@pytest.mark.parametrize("B,S,H,Hkv,D,window,dtype", [
    (2, 150, 4, 2, 32, None, "float32"),
    (1, 300, 4, 1, 16, 40, "float32"),
    (2, 130, 8, 2, 64, 64, "float32"),
    (2, 96, 4, 2, 16, 16, "bfloat16"),
])
def test_flash_attention_vs_jax_chunked_and_dense(B, S, H, Hkv, D, window,
                                                  dtype):
    """Causal self-attention as the model calls it, with and without a
    sliding window (chunked_attention's blocks of 512/1024 and the
    triangular path against the port's 64-key tiles)."""
    (jq, jk, jv), (q, k, v) = _inputs(B, S, S, H, Hkv, D, dtype, seed=S)
    got = flash_attention(q, k, v, causal=True, window=window)
    _close(got, JL.chunked_attention(jq, jk, jv, causal=True, window=window),
           dtype, "chunked")
    _close(got, JL.dense_attention(jq, jk, jv, causal=True, window=window),
           dtype, "dense")


@pytest.mark.parametrize("Sq,Sk,q_offset,window", [
    (32, 96, 64, None),         # the last 32 queries of a 96-token context
    (40, 200, 130, 50),         # windowed, offset past a tile edge
    (16, 16, -8, None),         # rows 0..7 see no key
])
def test_flash_attention_q_offset(Sq, Sk, q_offset, window):
    (jq, jk, jv), (q, k, v) = _inputs(2, Sq, Sk, 4, 2, 32, "float32",
                                      seed=Sq)
    got = flash_attention(q, k, v, causal=True, window=window,
                          q_offset=q_offset)
    want = JL.chunked_attention(jq, jk, jv, causal=True, window=window,
                                q_offset=q_offset)
    _close(got, want, "float32", "chunked")
    if q_offset >= 0:
        _close(got, JL.dense_attention(jq, jk, jv, causal=True, window=window,
                                       q_offset=q_offset), "float32", "dense")


def test_bf16_keeps_p_in_f32():
    """The Pallas kernel widens v to f32 before ``p.astype(v.dtype)``, so p
    is never rounded, and neither is it here.  Two keys with p = 1 and
    p = exp(-177/256) = 0.50087, which bf16 would round to 0.5, and v of
    -0.5 and 1: f32 p gives (0.50087 - 0.5) / 1.50087 = 5.8e-4, while p
    rounded to bf16, as the JAX model code's jnp twin rounds it, gives 0."""
    D = 16
    q = torch.zeros(1, 1, 1, D)
    q[..., 0] = 1.0
    k = torch.zeros(1, 2, 1, D)
    k[0, 1, 0, 0] = -177 / 256
    v = torch.stack([torch.full((D,), -0.5), torch.ones(D)])[None, :, None]
    q, k, v = (t.bfloat16() for t in (q, k, v))
    got = flash_attention(q, k, v, causal=False, scale=1.0)
    x = math.exp(-177 / 256)
    want = torch.full(got.shape, (x - 0.5) / (1 + x)).bfloat16()
    assert excess(got, want) <= 0, got
    twin = JL.chunked_attention(*(jnp.asarray(t.float().numpy(),
                                              jnp.bfloat16)
                                  for t in (q, k, v)),
                                causal=False, window=None, scale=1.0)
    assert not np.asarray(twin, np.float32).any()


def test_bf16_tolerance_separates_faults():
    """The element-wise bound that holds the CUDA kernel to this plain
    version (``ref.TOLERANCE``), at Llama-3.2-1B's head dim and 4096
    tokens: met by the same function summed in another order (JAX's oracle
    in f32 on the same bf16 inputs, rounded to bf16 at the end), failed by
    an output that skips the last KV tile or mis-scales the late rows by
    2**-6."""
    B, S, H, Hkv, D = 1, 4096, 2, 1, 64
    (jq, jk, jv), (q, k, v) = _inputs(B, S, S, H, Hkv, D, "bfloat16", seed=4)
    want = flash_fwd_ref(q, k, v, causal=True)
    jq, jk, jv = (jnp.repeat(a.astype(jnp.float32), H // h, 2).transpose(
        0, 2, 1, 3) for a, h in ((jq, H), (jk, Hkv), (jv, Hkv)))
    other = np.asarray(jax_attention_ref(jq, jk, jv, causal=True))
    other = torch.from_numpy(other.transpose(0, 2, 1, 3).copy()).bfloat16()
    assert excess(other, want) <= 0
    skipped = want.clone()
    skipped[:, S - 64:] = flash_fwd_ref(q[:, S - 64:], k[:, :S - 64],
                                        v[:, :S - 64], causal=True,
                                        q_offset=S - 64)
    scaled = want.float()
    scaled[:, S // 2:] *= 1 + 2.0 ** -6
    for bad in (skipped, scaled.bfloat16()):
        assert excess(bad, want) > 0
        # an absolute 5e-2, about a typical output here, lets it through
        assert float((bad.float() - want.float()).abs().max()) < 5e-2


def test_fully_masked_rows_give_zero():
    _, (q, k, v) = _inputs(1, 16, 16, 2, 1, 16, "float32")
    out = flash_attention(q, k, v, causal=True, q_offset=-8)
    assert torch.equal(out[:, :8], torch.zeros_like(out[:, :8]))
    assert bool(out[:, 8:].abs().sum(-1).gt(0).all())
    # no key at all
    out = flash_attention(q, k[:, :0], v[:, :0], causal=False)
    assert out.shape == q.shape and not bool(out.any())


def test_kv_range_skips_only_masked_tiles():
    """Tiles outside kv_range are masked for every query: the recurrence
    over all of them gives the same result bit for bit."""
    assert kv_range(100, 300, causal=True, window=None) == (0, 100)
    assert kv_range(40, 200, causal=True, window=50, q_offset=130) == (81, 170)
    assert kv_range(10, 50, causal=False, window=None) == (0, 50)
    assert kv_range(8, 8, causal=True, window=None, q_offset=-9) == (0, 0)
    _, (q, k, v) = _inputs(1, 40, 200, 2, 2, 16, "float32")
    got = flash_fwd_ref(q, k, v, causal=True, window=50, q_offset=130)
    # the same keys with 64 masked ones in front: two more tiles to skip
    pad = torch.zeros(1, 64, 2, 16)
    got2 = flash_fwd_ref(q, torch.cat([pad, k], 1), torch.cat([pad, v], 1),
                         causal=True, window=50, q_offset=194)
    assert torch.equal(got, got2)


def test_flash_attention_refuses_bad_input():
    _, (q, k, v) = _inputs(1, 8, 8, 3, 2, 16, "float32")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k, v)
    _, (q, k, v) = _inputs(1, 8, 8, 4, 2, 16, "float32")
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)       # no plain route on this path


# --------------------------------------------------------------------------
# the bf16 kernel's roundings (csrc/flash_fwd_bf16.cu), as a plain twin
# --------------------------------------------------------------------------
def _bf16_kernel_twin(q, k, v, *, causal=True, window=None, scale=None,
                      q_offset=0, split=True):
    """The bf16 kernel's arithmetic in plain PyTorch: f32 scores q·k from
    the bf16 operands, then ·(scale·log2 e) in f32 (the kernel's wgmma has
    no place for q·scale, and its exp is exp2 of scores in log2 units);
    the ``flash_fwd_ref`` recurrence over 64-key tiles; p split into p_hi =
    bf16(p) and p_lo = bf16(p - p_hi), both multiplied by v into one f32
    accumulator, l summed in f32 in tile order.  With ``split=False``, p
    is rounded to bf16 once, as a single bf16 wgmma would take it."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scale2 = torch.tensor(scale) * torch.tensor(math.log2(math.e))   # f32
    qf = q.float().permute(0, 2, 1, 3).reshape(B, Hkv, rep, Sq, D)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    q_abs = torch.arange(Sq) + q_offset
    acc = torch.zeros(B, Hkv, rep, Sq, D)
    m = torch.full((B, Hkv, rep, Sq), -torch.inf)
    l = torch.zeros(B, Hkv, rep, Sq)
    lo, hi = kv_range(Sq, Sk, causal=causal, window=window, q_offset=q_offset)
    for k0 in range(lo // KV_TILE * KV_TILE, hi, KV_TILE):
        k1 = min(k0 + KV_TILE, Sk)
        s = (qf @ kf[..., k0:k1, :].transpose(-1, -2)) * scale2
        msk = attention_mask(q_abs, torch.arange(k0, k1), Sk, causal, window)
        s = torch.where(msk, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.where(msk, torch.exp2(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp2(m - m_safe))
        l = l * alpha + p.sum(-1)
        p_hi = p.bfloat16().float()
        acc = acc * alpha[..., None] + p_hi @ vf[..., k0:k1, :]
        if split:
            p_lo = (p - p_hi).bfloat16().float()
            acc = acc + p_lo @ vf[..., k0:k1, :]
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l[..., None]).bfloat16()
    return out.reshape(B, H, Sq, D).permute(0, 2, 1, 3)


# the cases each kernel's rounding twin is held to the plain version on
ROUNDING_CASES = [
    (2, 150, 150, 4, 1, 16, True, None, 0),
    (1, 200, 200, 8, 2, 64, True, None, 0),
    (1, 130, 130, 4, 4, 64, False, None, 0),
    (1, 70, 200, 4, 2, 80, True, 50, 130),       # h2o-danube's head dim
    (2, 100, 100, 2, 2, 80, True, 33, 0),
    (1, 96, 96, 2, 1, 128, True, None, 0),
    (1, 40, 170, 8, 1, 128, True, None, -20),    # rows that see no key
]


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,q_offset",
                         ROUNDING_CASES)
def test_bf16_kernel_roundings_meet_the_plain_version(B, Sq, Sk, H, Hkv, D,
                                                      causal, window,
                                                      q_offset):
    """The kernel's own roundings (scale·log2 e after the f32 scores, exp2,
    p as p_hi + p_lo, sums in tile order) stay within ``ref.TOLERANCE`` of
    ``flash_fwd_ref`` element by element, also where the scale is not a
    power of 2 (D 80), and near JAX's oracle."""
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, H, Hkv, D, "bfloat16",
                                      seed=Sq * D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    twin = _bf16_kernel_twin(q, k, v, **kw)
    assert twin.dtype == torch.bfloat16 and twin.shape == q.shape
    assert excess(twin, flash_fwd_ref(q, k, v, **kw)) <= 0
    if q_offset == 0:
        _close(twin, JL.chunked_attention(jq, jk, jv, **kw), "bfloat16",
               "chunked")


def test_bf16_kernel_split_keeps_p_in_f32():
    """On test_bf16_keeps_p_in_f32's inputs the twin gives (x - 0.5) /
    (1 + x) = 5.8e-4 within the bound; the same twin with p rounded to
    bf16 once gives 0 and fails it: the kernel needs the split."""
    D = 16
    q = torch.zeros(1, 1, 1, D)
    q[..., 0] = 1.0
    k = torch.zeros(1, 2, 1, D)
    k[0, 1, 0, 0] = -177 / 256
    v = torch.stack([torch.full((D,), -0.5), torch.ones(D)])[None, :, None]
    q, k, v = (t.bfloat16() for t in (q, k, v))
    x = math.exp(-177 / 256)
    want = torch.full((1, 1, 1, D), (x - 0.5) / (1 + x)).bfloat16()
    kw = dict(causal=False, scale=1.0)
    got = _bf16_kernel_twin(q, k, v, **kw)
    assert excess(got, want) <= 0 and excess(got, flash_fwd_ref(q, k, v,
                                                                 **kw)) <= 0
    assert float(got[0, 0, 0, 0]) == pytest.approx(5.8e-4, rel=0.01)
    single = _bf16_kernel_twin(q, k, v, split=False, **kw)
    assert not single.any()
    assert excess(single, want) > 0


@pytest.mark.parametrize("D", [16, 64, 80, 128])
def test_views_the_bf16_kernel_reads_without_a_copy(D):
    """The wrapper's rule for what the bf16 kernel (TMA) reads as it is:
    contiguous tensors and head-dim slices of a fused qkv projection; not a
    view whose rows start off a 16-byte boundary or whose head dim is
    strided.  Dims of length 1 get the contiguous stride."""
    B, S, H, Hkv = 2, 50, 8, 2
    qkv = torch.zeros(B, S, (H + 2 * Hkv) * D, dtype=torch.bfloat16)
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + Hkv) * D].view(B, S, Hkv, D)
    v = qkv[..., (H + Hkv) * D:].view(B, S, Hkv, D)
    assert all(ops.readable(t) for t in (q, k, v))
    assert not q.is_contiguous()
    assert ops._strides(q) == [S * (H + 2 * Hkv) * D, (H + 2 * Hkv) * D, D]
    shifted = qkv[..., 8:8 + H * D].view(B, S, H, D)    # 16 bytes in: fine
    assert ops.readable(shifted)
    off = qkv[..., 1:1 + H * D].view(B, S, H, D)        # 2 bytes in
    assert not ops.readable(off)
    assert not ops.readable(q.transpose(2, 3))
    # f32 rows are read in 16-byte pieces too (cp.async, float4 loads)
    assert ops.readable(off.float())
    assert not ops.readable(off.float()[..., 1:])
    one = torch.zeros(1, 1, 1, D, dtype=torch.bfloat16)
    assert ops._strides(one) == [D, D, D] and ops.readable(one)


@pytest.mark.parametrize("D", [16, 48, 64, 128])
def test_views_the_f32_kernel_reads_without_a_copy(D):
    """The f32 kernel's rule: the bf16 rule in bytes, so 4 f32 elements a
    16-byte piece.  A fused f32 qkv projection's head-dim slices are read
    as they are; a slice one element in, or with rows 2 elements apart, is
    not."""
    B, S, H, Hkv = 2, 50, 8, 2
    qkv = torch.zeros(B, S, (H + 2 * Hkv) * D)
    q = qkv[..., :H * D].view(B, S, H, D)
    k = qkv[..., H * D:(H + Hkv) * D].view(B, S, Hkv, D)
    v = qkv[..., (H + Hkv) * D:].view(B, S, Hkv, D)
    assert all(ops.readable(t) for t in (q, k, v))
    assert ops.readable(qkv[..., 4:4 + H * D].view(B, S, H, D))
    assert not ops.readable(qkv[..., 1:1 + H * D].view(B, S, H, D))
    # tokens H·D + 2 elements apart: every other row off a 16-byte boundary
    odd = torch.zeros(B * S * (H * D + 2)).as_strided(
        (B, S, H, D), (S * (H * D + 2), H * D + 2, D, 1))
    assert not ops.readable(odd)
    wide = torch.zeros(B, S, H, D + 2)[..., :D]         # heads D + 2 apart
    assert not ops.readable(wide)


# --------------------------------------------------------------------------
# the f32 kernel's plan and roundings (csrc/flash_fwd.cu)
# --------------------------------------------------------------------------
@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_f32_plan_fits_the_card(D):
    """The plan the f32 kernel reports (its Python mirror here; the card's
    own report is held to this mirror by a ``gpu`` test) fits an H100: its
    shared memory fits a CTA, the CTAs an SM it asks for fit the SM's
    shared memory with their reserves and leave each thread the most
    registers a thread may have (255), and no more CTAs fit by shared
    memory without cutting registers; its tiles divide among its threads."""
    p = ops.f32_plan(D)
    assert set(p) == set(ops.F32_PLAN_KEYS)
    assert p["smem_bytes"] <= 232_448       # the most an H100 CTA may take
    assert p["ctas_per_sm"] * (p["smem_bytes"] + ops.CTA_RESERVED_BYTES) \
        <= ops.SM_SHARED_BYTES
    assert p["ctas_per_sm"] * p["threads"] * 255 <= 65_536
    fits = ops.SM_SHARED_BYTES // (p["smem_bytes"] + ops.CTA_RESERVED_BYTES)
    assert p["ctas_per_sm"] == min(2, fits) >= 1
    # 8 rows a thread, 8 threads a row group; 8 or 4 keys a thread
    assert p["threads"] == p["rows"] // 8 * 8
    assert p["keys"] in (32, 64)
    assert p["keys"] * D // 4 % p["threads"] == 0     # 16-byte copies
    assert p["stages"] >= 2
    # Llama-3.2-1B's head dim: two CTAs an SM
    if D == 64:
        assert p["ctas_per_sm"] == 2 and p["smem_bytes"] == 115_200
    with pytest.raises(ValueError, match="head dim"):
        ops.f32_plan(D + 8)


@pytest.mark.parametrize("B,Sq,H", [(1, 1, 1), (4, 4096, 32),
                                    (1, 131_072, 65_535), (65_535, 128, 1)])
def test_f32_grid_stays_within_cuda_limits(B, Sq, H):
    """One CTA per (128 query rows, batch, head) on a one-dimensional grid:
    within gridDim.x's limit, which the plan reports, at B·H up to 65,535
    (the y limit the bf16 kernel's grid keeps) and 131,072 tokens."""
    n = ops.f32_ctas(B, Sq, H)
    assert n == -(-Sq // 128) * B * H
    assert n <= ops.f32_plan(64)["max_ctas"] == ops.MAX_GRID_X == 2 ** 31 - 1


def _f32_kernel_twin(q, k, v, *, causal=True, window=None, scale=None,
                     q_offset=0):
    """The f32 kernel's arithmetic in plain PyTorch: q·(scale·log2 e)
    rounded to f32 (staged once a CTA), f32 scores in log2 units, exp2,
    the ``flash_fwd_ref`` recurrence over the kernel's key tiles (64 keys,
    32 for D > 64), p and the accumulator in f32."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    tile = ops.f32_plan(D)["keys"]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scale2 = torch.tensor(scale) * torch.tensor(math.log2(math.e))   # f32
    qs = (q.permute(0, 2, 1, 3).reshape(B, Hkv, rep, Sq, D) * scale2)
    kf = k.permute(0, 2, 1, 3)[:, :, None]
    vf = v.permute(0, 2, 1, 3)[:, :, None]
    q_abs = torch.arange(Sq) + q_offset
    acc = torch.zeros(B, Hkv, rep, Sq, D)
    m = torch.full((B, Hkv, rep, Sq), -torch.inf)
    l = torch.zeros(B, Hkv, rep, Sq)
    lo, hi = kv_range(Sq, Sk, causal=causal, window=window, q_offset=q_offset)
    for k0 in range(lo // tile * tile, hi, tile):
        k1 = min(k0 + tile, Sk)
        s = qs @ kf[..., k0:k1, :].transpose(-1, -2)
        msk = attention_mask(q_abs, torch.arange(k0, k1), Sk, causal, window)
        s = torch.where(msk, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp2(s - m_safe[..., None])
        alpha = torch.where(torch.isneginf(m), 0.0, torch.exp2(m - m_safe))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vf[..., k0:k1, :]
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    out = acc / l[..., None]
    return out.reshape(B, H, Sq, D).permute(0, 2, 1, 3)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,causal,window,q_offset",
                         ROUNDING_CASES)
def test_f32_kernel_roundings_meet_the_plain_version(B, Sq, Sk, H, Hkv, D,
                                                     causal, window,
                                                     q_offset):
    """The f32 kernel's own roundings (q·scale·log2 e rounded once, exp2
    of scores in log2 units, its key tiles) stay within
    ``ref.TOLERANCE[float32]`` of ``flash_fwd_ref`` element by element,
    on the bf16 twin's cases (D 80: a scale that is not a power of 2), and
    near JAX's model code."""
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Sk, H, Hkv, D, "float32",
                                      seed=Sq * D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    twin = _f32_kernel_twin(q, k, v, **kw)
    want = flash_fwd_ref(q, k, v, **kw)
    assert twin.dtype == torch.float32 and twin.shape == q.shape
    assert excess(twin, want) <= 0
    if q_offset < 0:
        assert not twin[:, :-q_offset].any()
    if q_offset == 0:
        _close(twin, JL.chunked_attention(jq, jk, jv, **kw), "float32",
               "chunked")
