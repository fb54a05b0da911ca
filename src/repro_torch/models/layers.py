"""Transformer layer primitives: plain functions on tensors.

The PyTorch port of the JAX package's ``models/layers.py``.  Conventions
kept from there:

* Parameters sit in :class:`Params` bags named as the JAX package's param
  dicts (``p["wq"]``, ``"wg" in p``), in its layouts: a projection is
  ``x @ w`` with w (d_in, d_out), so weights carry across unchanged
  (``models/convert.py``).
* Activations are ``cfg.dtype``; norms, softmax and the logits accumulate in
  f32 (the JAX package's ``preferred_element_type=f32`` becomes an f32
  product of the widened operands).
* Attention is GQA with RoPE on two paths: ``dense`` materialises the
  (B, H, Sq, Sk) scores in plain torch; ``chunked`` is the flash-attention
  recurrence, which on a CUDA tensor is the hand-written kernel
  (``kernels/flash_attn``) and on a CPU tensor its plain twin.  Its
  gradient is :class:`FlashAttention`'s backward, the JAX package's
  FlashAttention-2 VJP as blockwise torch tensor code.
* Sliding-window attention (h2o-danube) masks both paths.

On a mesh (``rt.mesh``) the tensors are DTensors and DTensor propagates
the projections' shardings; three regions run under ``local_map``, on each
rank's local tensors, because a DTensor cannot reach the kernel (its
``data_ptr``) or has no sharding strategy for the op:

* the attention (:func:`attention_region`): q/k/v with batch over the dp
  axes and heads over tp, so each rank runs ``flash_fwd`` (or the dense
  path) on its own heads, causal or not, self- or cross-attention (the
  keys' length may differ from the queries'); heads that do not divide
  tp are padded to the next multiple, kv heads that do not divide it
  repeated first, as the JAX package's ``chunked_attention`` does;
* the decode step's cache write and attention (:func:`decode_region`), on
  the cache's own layout: heads over tp, or, where the kv heads do not
  divide tp (or the plan shards the cache's sequence), the sequence, with
  the softmax's max, sum and product reduced across the sequence's ranks;
* the embedding lookup (:func:`embed_rows`) on a vocab-sharded table:
  each tp rank looks up the tokens its rows hold, zeros elsewhere, and
  the sum over tp (a ``Partial`` placement) is the row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..kernels.flash_attn import flash_attention
from ..kernels.flash_attn.ref import attention_mask, kv_range
from . import collectives as C
from .runtime import placements


class Params(nn.Module):
    """A named bag of parameter tensors and nested bags (or other
    modules), indexed like the JAX package's param dicts: ``p["wq"]`` is a
    tensor, ``p["shared"]["wg"]`` a tensor of a nested bag.  Its tensors
    are made requiring no gradient, for serving; ``requires_grad_(True)``
    on the model (``train.train_step.init_state`` calls it) makes them
    trainable."""

    def __init__(self, **items):
        super().__init__()
        for name, t in items.items():
            if isinstance(t, nn.Module):
                self.add_module(name, t)
            else:
                self.register_parameter(name,
                                        nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def checkpoint(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward, as
    ``jax.checkpoint``: autograd keeps only the inputs.  Where no gradient
    is being recorded it is ``fn(*args)``.  The model code draws no random
    numbers, so no RNG state is kept for the recompute."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _run(layers, step, x):
    for p in layers:
        x = step(p, x)
    return x


def run_layers(layers, step, x, remat: bool, group: int = 1):
    """``x = step(p, x)`` for each layer p in order (``x`` a tensor or a
    tuple of them).  With ``remat`` (and a gradient being recorded, see
    :func:`checkpoint`) each layer is checkpointed or, with
    ``group`` > 1, each run of ``group`` layers (its input saved once, its
    interior recomputed once in the backward), the layers that fill no run
    checkpointed one by one: the JAX package's grouped remat
    (``transformer._scan_blocks``)."""
    layers = list(layers)
    if not remat:
        return _run(layers, step, x)
    n = len(layers) // group * group if group > 1 else 0
    spans = [layers[i:i + group] for i in range(0, n, group)]
    for span in spans + [[p] for p in layers[n:]]:
        x = checkpoint(lambda x, span=span: _run(span, step, x), x)
    return x


# --------------------------------------------------------------------------
# initialisation helpers
# --------------------------------------------------------------------------
def _dense_init(gen: torch.Generator, shape, dtype,
                scale: float | None = None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def _zeros(gen: torch.Generator, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def init_rmsnorm(gen: torch.Generator, d: int, dtype) -> Params:
    return Params(scale=torch.ones(d, dtype=dtype, device=gen.device))


def rms_norm(x, params: Params, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------
def rope_angles(positions, head_dim: int, theta: float):
    """(..., S) int positions -> cos/sin tables (..., S, head_dim/2), fp32."""
    half = head_dim // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D). cos/sin: (..., S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if x.ndim == 4 and cos.ndim == 2:         # (B, S, H, D) with (S, half)
        c = cos[None, :, None, :].to(x.dtype)
        s = sin[None, :, None, :].to(x.dtype)
    elif x.ndim == cos.ndim + 2:
        c, s = cos[..., None, :].to(x.dtype), sin[..., None, :].to(x.dtype)
    else:
        c, s = cos.to(x.dtype), sin.to(x.dtype)
    # rotate-half convention (llama/qwen)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# --------------------------------------------------------------------------
# attention (GQA + optional sliding window), dense and chunked paths
# --------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    p = {
        "wq": _dense_init(gen, (d, nq * hd), dt),
        "wk": _dense_init(gen, (d, nkv * hd), dt),
        "wv": _dense_init(gen, (d, nkv * hd), dt),
        "wo": _dense_init(gen, (nq * hd, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, (nq * hd,), dt)
        p["bk"] = _zeros(gen, (nkv * hd,), dt)
        p["bv"] = _zeros(gen, (nkv * hd,), dt)
    return Params(**p)


def _qkv(params: Params, x, cfg):
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = _heads(q, cfg.n_heads, cfg.head_dim)
    k = _heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _heads(v, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _heads(t, n: int, hd: int):
    """(B, S, n·hd) -> (B, S, n, hd).  A DTensor whose features are
    sharded over axes whose width does not divide ``n`` (2 kv heads on a
    4-wide model axis) is first made whole along them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.ndim - 1
        width = 1
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim % t.ndim == last:
                width *= mesh.size(i)
        if n % width:
            t = t.redistribute(mesh, tuple(
                Replicate() if isinstance(p, Shard) and p.dim % t.ndim == last
                else p for p in t.placements))
    return t.reshape(t.shape[0], t.shape[1], n, hd)


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    B, S, H, D = k.shape
    return k[:, :, :, None, :].expand(B, S, H, n_rep, D).reshape(
        B, S, H * n_rep, D)


def dense_attention(q, k, v, *, causal: bool, window: int | None,
                    q_offset: int = 0, scale: float | None = None):
    """Materialised-scores attention. q:(B,Sq,H,D) k/v:(B,Sk,Hkv,D)."""
    Sq, H, D = q.shape[1], q.shape[2], q.shape[3]
    Sk, Hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // Hkv)
    v = _repeat_kv(v, H // Hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(torch.arange(Sq, device=q.device) + q_offset,
                          torch.arange(Sk, device=q.device), Sk, causal,
                          window)
    scores = torch.where(mask, scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _all_visible(q0: int, q1: int, k0: int, k1: int, causal: bool,
                 window: int | None, q_offset: int) -> bool:
    """Whether every query of [q0, q1) may see every key of [k0, k1)."""
    if causal and k1 - 1 > q0 + q_offset:
        return False
    return window is None or k0 > q1 - 1 + q_offset - window


def flash_bwd(q, k, v, out, dout, *, causal: bool, window: int | None,
              q_offset: int = 0, scale: float | None = None,
              q_blk: int = 512, kv_blk: int = 1024):
    """The gradients (dq, dk, dv) of flash attention, blockwise.

    A port of the JAX package's FlashAttention-2 backward
    (``models/layers.py::_flash_vjp_bwd``) as torch tensor code.  q and
    dout (B, Sq, H, D), k/v (B, Sk, Hkv, D), out the forward's result.
    Neither kernel returns the rows' log-sum-exp, so a first pass over each
    query block's key blocks recomputes it in f32 from the rounded q·scale
    and k, as the JAX forward computes it; a second pass recomputes the
    scores and takes ``p = exp(s - lse)``, masked, then ``dv``, ``dp``,
    ``ds = p·(dp - D)·scale`` with ``D = rowsum(dout·out)``, ``dq`` and
    ``dk``.  The cast points are the JAX code's: q·scale rounded to q's
    dtype, p to dout's before dv, ds to q's before dq and dk; every
    product is an f32 product of the widened operands and the sums run in
    f32, dq over key blocks and dk/dv over query blocks in order.  GQA:
    the queries of a KV head are taken together, so dk and dv come back
    (B, Sk, Hkv, D), summed over each group of H / Hkv query heads in f32
    (the JAX package rounds each repeated head's before it adds them).
    Key blocks that the mask leaves empty for a query block are skipped,
    the work the JAX package's triangular schedule saves; blocks wholly
    inside the mask are not masked.  Returns the gradients in the inputs'
    dtypes.
    """
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device

    def grouped(t):                         # (B,S,H,D) -> (B,Hkv,rep,S,D)
        return t.permute(0, 2, 1, 3).reshape(B, Hkv, rep, t.shape[1], D)

    # q·scale rounded to q's dtype, by the scale in q's dtype, as the JAX
    # code's weakly typed product
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    qs = (grouped(q).float() * scale_q).to(q.dtype)
    qg, dog, og = grouped(q), grouped(dout), grouped(out)
    kf = k.permute(0, 2, 1, 3).float()                   # (B,Hkv,Sk,D)
    vf = v.permute(0, 2, 1, 3).float()
    dq = torch.empty(B, Hkv, rep, Sq, D, dtype=torch.float32, device=dev)
    dk = torch.zeros(B, Hkv, Sk, D, dtype=torch.float32, device=dev)
    dv = torch.zeros(B, Hkv, Sk, D, dtype=torch.float32, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    for q0 in range(0, Sq, q_blk):
        q1 = min(q0 + q_blk, Sq)
        n = (q1 - q0) * rep

        def rows(t):                        # (B,Hkv,rep·n_q,D) f32
            return t[:, :, :, q0:q1].float().reshape(B, Hkv, n, D)
        qs_i, q_i, do_i = rows(qs), rows(qg), rows(dog)
        drow = (do_i * rows(og)).sum(-1)                 # (B,Hkv,rep·n_q)
        q_abs = torch.arange(q0, q1, device=dev) + q_offset
        lo, hi = kv_range(q1 - q0, Sk, causal=causal, window=window,
                          q_offset=q0 + q_offset)
        blocks = []
        for k0 in range(lo // kv_blk * kv_blk, hi, kv_blk):
            k1 = min(k0 + kv_blk, Sk)
            msk = None
            if not _all_visible(q0, q1, k0, k1, causal, window, q_offset):
                msk = attention_mask(q_abs, k_pos[k0:k1], Sk, causal,
                                     window).repeat(rep, 1)
            blocks.append((k0, k1, msk))

        def scores(k0, k1, msk):
            s = qs_i @ kf[:, :, k0:k1].transpose(-1, -2)
            return s if msk is None else torch.where(msk, s, -torch.inf)
        # pass 1: each row's log-sum-exp (0 where a row sees no key)
        m = torch.full((B, Hkv, n), -torch.inf, device=dev)
        l = torch.zeros(B, Hkv, n, device=dev)
        for k0, k1, msk in blocks:
            s = scores(k0, k1, msk)
            m_new = torch.maximum(m, s.amax(-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            if msk is not None:
                p = torch.where(msk, p, 0.0)
            alpha = torch.where(torch.isneginf(m), 0.0,
                                torch.exp(m - m_safe))
            l = l * alpha + p.sum(-1)
            m = m_new
        lse = torch.where(l > 0.0, m + torch.log(l.clamp_min(1e-37)), 0.0)
        # pass 2: the gradients
        dq_i = torch.zeros(B, Hkv, n, D, device=dev)
        for k0, k1, msk in blocks:
            p = torch.exp(scores(k0, k1, msk) - lse[..., None])
            if msk is not None:
                p = torch.where(msk, p, 0.0)
            pc = p.to(dout.dtype).float()
            dv[:, :, k0:k1] += pc.transpose(-1, -2) @ do_i
            dp = do_i @ vf[:, :, k0:k1].transpose(-1, -2)
            ds = (p * (dp - drow[..., None]) * scale).to(q.dtype).float()
            dq_i += ds @ kf[:, :, k0:k1]
            dk[:, :, k0:k1] += ds.transpose(-1, -2) @ q_i
        dq[:, :, :, q0:q1] = dq_i.view(B, Hkv, rep, q1 - q0, D)
    dq = dq.reshape(B, H, Sq, D).permute(0, 2, 1, 3).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: the forward is
    :func:`flash_attention` (the hand-written ``flash_fwd`` kernel on a
    CUDA tensor, its plain twin on a CPU tensor), the backward
    :func:`flash_bwd`.  Saves q, k, v and the output, O(S) beside the
    O(S²) scores that autograd through a plain recurrence would keep."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, q_blk,
                kv_blk):
        out = flash_attention(q, k, v, causal=causal, window=window,
                              scale=scale, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        scale=scale, q_blk=q_blk, kv_blk=kv_blk)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        return (*flash_bwd(q, k, v, out, dout, **ctx.opts),
                None, None, None, None, None, None)


def chunked_attention(q, k, v, *, causal: bool, window: int | None,
                      q_offset: int = 0, scale: float | None = None,
                      q_blk: int = 512, kv_blk: int = 1024):
    """Flash-style online-softmax attention, O(S·tile) working set,
    forward and backward.

    In the JAX package, the pure-jnp twin of its Pallas kernel with a
    custom VJP; here :class:`FlashAttention`: the forward is
    :func:`flash_attention` itself (on a CUDA tensor the hand-written
    ``flash_fwd`` kernel, on a CPU tensor its plain recurrence
    ``flash_fwd_ref``), the backward the JAX VJP as torch code.  The
    forward computes the Pallas kernel's function, which keeps p and
    q·scale in f32: in bf16 the JAX twin rounds both to bf16, so the two
    part by a bf16 rounding.  ``q_blk``/``kv_blk`` block the backward only
    (the kernel's tiles are fixed), with the JAX package's defaults and
    its rule: square blocks for causal self-attention.
    """
    Sq, Sk = q.shape[1], k.shape[1]
    q_blk, kv_blk = min(q_blk, Sq), min(kv_blk, Sk)
    if causal and window is None and q_offset == 0 and Sq == Sk:
        kv_blk = q_blk
    return FlashAttention.apply(q, k, v, causal, window, q_offset, scale,
                                max(q_blk, 1), max(kv_blk, 1))


def resolve_mode(mode: str, S: int) -> str:
    """``auto`` is ``chunked`` past 2048 tokens, else ``dense``."""
    if mode == "auto":
        return "chunked" if S > 2048 else "dense"
    return mode


def attention_fwd(params: Params, x, cfg, *, positions=None, causal=True,
                  mode: str = "auto", q_offset: int = 0,
                  return_kv: bool = False, rt=None):
    """Self-attention over x:(B,S,D) -> (B,S,D), or with ``return_kv``
    (out, k, v): the roped keys and the values, (B,S,Hkv,hd), that prefill
    writes into the KV cache.  With a mesh in ``rt`` the attention runs in
    :func:`attention_region`."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device) + q_offset
    if cfg.pos_emb == "rope":
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        cos, sin = replicated_like(cos, q), replicated_like(sin, q)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    window = cfg.sliding_window
    attn = chunked_attention if resolve_mode(mode, S) == "chunked" \
        else dense_attention

    def fn(q, k, v):
        return attn(q, k, v, causal=causal, window=window,
                    q_offset=q_offset)
    if rt is not None and rt.mesh is not None:
        out = attention_region(rt, fn, q, k, v)
    else:
        out = fn(q, k, v)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ attn_wo(params,
                                                                  cfg, rt)
    return (out, k, v) if return_kv else out


def attn_wo(params: Params, cfg, rt=None):
    """The output projection of an attention's heads, as it meets
    :func:`attention_region`'s output: where the heads are padded over tp
    that output leaves whole, and so does wo, whose rows tp would split
    inside a head."""
    wo = params["wo"]
    if rt is not None and rt.mesh is not None \
            and _padded_heads(rt, cfg.n_heads):
        wo = wo.redistribute(rt.mesh, placements((), rt.mesh))
    return wo


def _padded_heads(rt, n_heads: int) -> bool:
    """Whether ``n_heads`` are padded to a multiple of the tp width."""
    ntp = rt.size(rt.tp_axis) if rt.tp_axis else 1
    return ntp > 1 and n_heads % ntp != 0


def replicated_like(t, ref):
    """``t`` as a DTensor replicated on ``ref``'s mesh where ``ref`` is a
    DTensor, else ``t``.  A plain tensor that an autograd op saves beside
    DTensors must be one: the backward runs without the forward's
    implicit replication."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False)


def _spec(rt, n: int, dims: dict, shape) -> tuple:
    """An n-dim spec from {dim: axes}, an entry dropped where its axes'
    width does not divide the dim."""
    out = [None] * n
    for d, axes in dims.items():
        if axes and shape[d] % rt.size(axes) == 0:
            out[d] = axes
    return tuple(out)


def attention_region(rt, fn, q, k, v):
    """``fn(q, k, v) -> out`` (q, out (B,S,H,hd); k, v (B,S,Hkv,hd)) on
    each rank's heads under ``local_map``: batch over the dp axes, heads
    over tp.  KV heads that do not divide tp are repeated to H first;
    heads that do not divide it are padded with zero heads to the next
    multiple on every rank, and each rank runs its own slice of them (the
    padded heads' outputs are cut off)."""
    from torch.distributed.tensor.experimental import local_map
    mesh, tp = rt.mesh, rt.tp_axis
    H, Hkv = q.shape[2], k.shape[2]
    ntp = rt.size(tp) if tp else 1
    if ntp > 1 and Hkv % ntp:
        k, v = _repeat_kv(k, H // Hkv), _repeat_kv(v, H // Hkv)
    dp = rt.dp_axes or None
    pad = _padded_heads(rt, H)
    bdims = _spec(rt, 4, {0: dp}, q.shape)
    if pad:
        # every rank holds all heads, pads them and runs its own slice
        Hp = -(-H // ntp) * ntp
        n_loc = Hp // ntp

        def local(q, k, v):
            r = mesh.get_local_rank(tp)
            z = Hp - H
            q, k, v = (F.pad(t, (0, 0, 0, z)) for t in (q, k, v))
            sl = slice(r * n_loc, (r + 1) * n_loc)
            return fn(q[:, :, sl], k[:, :, sl], v[:, :, sl])
        ins = (placements(bdims, mesh),) * 3
        grads = (placements(bdims, mesh, partial=tp),) * 3
        out_pl = placements(bdims[:2] + (tp, None), mesh)
        out = local_map(local, out_placements=list(out_pl), in_placements=ins,
                        in_grad_placements=grads, device_mesh=mesh,
                        redistribute_inputs=True)(q, k, v)
        # whole over tp before the padding is cut: H heads do not split
        # over tp, in the forward's merge of the heads nor its backward
        out = out.redistribute(mesh, placements(bdims, mesh))
        return out[:, :, :H]
    spec = bdims[:2] + ((tp if ntp > 1 else None), None)
    pl = placements(spec, mesh)
    return local_map(fn, out_placements=list(pl), in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def attention_decode(params: Params, x, cfg, cache_k, cache_v,
                     cache_len: int, rt=None, layer: int | None = None):
    """One-token decode with a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, Hkv, hd), or with ``layer`` the
    stacked (L, B, S_max, Hkv, hd) caches and the layer to use; cache_len:
    number of valid cache positions.  Returns (out, cache_k, cache_v).
    Unlike the JAX package, which returns updated copies, the new position
    is written into the cache in place: a step allocates no cache.  With a
    mesh in ``rt`` the write and the attention run in
    :func:`decode_region`.
    """
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    if cfg.pos_emb == "rope":
        pos = torch.full((1,), cache_len, dtype=torch.int32, device=x.device)
        cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if rt is not None and rt.mesh is not None:
        out = decode_region(rt, cfg, q, k, v, cache_k, cache_v, cache_len,
                            layer)
    else:
        ck = cache_k if layer is None else cache_k[layer]
        cv = cache_v if layer is None else cache_v[layer]
        out = _decode_attend(q, k, v, ck, cv, cache_len, cfg)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ params["wo"]
    return out, cache_k, cache_v


def _decode_attend(q, k, v, cache_k, cache_v, cache_len: int, cfg,
                   seq0: int = 0, reduce=None, score_sum=None):
    """Write k, v (B,1,Hkv,hd) at ``cache_len`` into the cache (B, S,
    Hkv, hd) that holds positions [seq0, seq0 + S), and attend q (B,1,H,
    hd) over it -> (B,1,H,hd).  ``reduce(t, op)`` combines the softmax's
    max and sums and the weighted values across ranks that hold the
    sequence's other positions (None: this cache is the whole of it);
    ``score_sum(t)`` sums the scores across ranks that hold the head
    dim's other parts (None: the cache holds all of it)."""
    B = q.shape[0]
    S_loc, Hkv, hd = cache_k.shape[1], cache_k.shape[2], cache_k.shape[3]
    i = cache_len - seq0
    if 0 <= i < S_loc:
        cache_k[:, i] = k[:, 0].to(cache_k.dtype)
        cache_v[:, i] = v[:, 0].to(cache_v.dtype)
    H = q.shape[2]
    rep = H // Hkv
    # grouped-GQA einsum: the kv cache is never repeated
    qg = q.reshape(B, 1, Hkv, rep, hd)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), cache_k.float())
    if score_sum is not None:
        s = score_sum(s)
    s = s * scale
    kpos = torch.arange(S_loc, device=q.device) + seq0
    valid = kpos <= cache_len
    if cfg.sliding_window is not None:
        valid &= kpos > cache_len - cfg.sliding_window
    s = torch.where(valid, s, -torch.inf)
    if reduce is None:
        p = torch.softmax(s, dim=-1).to(q.dtype)
        out = torch.einsum("bkrqs,bskd->bqkrd", p, cache_v)
        return out.reshape(B, 1, H, hd)
    # the sequence spans ranks: the softmax from its global max and sum
    m = reduce(s.amax(-1, keepdim=True), "max")
    m = torch.where(torch.isneginf(m), 0.0, m)
    e = torch.exp(s - m)
    den = reduce(e.sum(-1, keepdim=True), "sum")
    num = reduce(torch.einsum("bkrqs,bskd->bqkrd", e, cache_v.float()),
                 "sum")
    out = num / den.permute(0, 3, 1, 2, 4)
    return out.to(q.dtype).reshape(B, 1, H, hd)


def decode_region(rt, cfg, q, k, v, cache_k, cache_v, cache_len: int,
                  layer: int | None):
    """The decode step's cache write and attention under ``local_map``,
    on the cache's own placements (no copy of the cache is made): heads
    over tp where the cache is head-sharded; else q and the new k, v
    replicated over the axes that shard the cache's sequence, each rank
    writing the position it holds and the softmax reduced across them;
    where the cache's head dim is sharded too (a long cache whose kv heads
    do not divide tp), q, k, v and the output are split on it like the
    cache, and the scores summed across its ranks."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = rt.mesh
    names = mesh.mesh_dim_names
    cpl = tuple(cache_k.placements)
    lead = 0 if layer is None else 1
    seq_axes = tuple(names[i] for i, p in enumerate(cpl)
                     if p == Shard(lead + 1))
    head_axes = tuple(names[i] for i, p in enumerate(cpl)
                      if p == Shard(lead + 2))
    batch_axes = tuple(names[i] for i, p in enumerate(cpl)
                       if p == Shard(lead))
    hd_axes = tuple(names[i] for i, p in enumerate(cpl)
                    if p == Shard(lead + 3))
    if any(p != Replicate() and p not in (Shard(lead), Shard(lead + 1),
                                          Shard(lead + 2), Shard(lead + 3))
           for p in cpl):
        raise NotImplementedError(f"decode on a cache placed {cpl}")
    spec = (batch_axes or None, None, head_axes or None, hd_axes or None)
    pl = placements(spec, mesh)

    def local(q, k, v, ck, cv):
        if layer is not None:
            ck, cv = ck[layer], cv[layer]
        score_sum = None
        if hd_axes:
            def score_sum(t):
                for a in hd_axes:
                    t = C.all_reduce(t, "sum", mesh, a)
                return t
        seq0, reduce = 0, None
        if seq_axes:
            idx = 0
            for a in seq_axes:
                idx = idx * rt.size(a) + mesh.get_local_rank(a)
            seq0 = idx * ck.shape[1]

            def reduce(t, op):
                for a in seq_axes:
                    t = C.all_reduce(t, op, mesh, a)
                return t
        return _decode_attend(q, k, v, ck, cv, cache_len, cfg, seq0, reduce,
                              score_sum)
    out = local_map(local, out_placements=list(pl),
                    in_placements=(pl, pl, pl, cpl, cpl), device_mesh=mesh,
                    redistribute_inputs=True)(q, k, v, cache_k, cache_v)
    if hd_axes:
        # whole over the head dim before the heads merge (torch 2.11 will
        # not flatten a sharded inner dim)
        out = out.redistribute(mesh, placements(spec[:3] + (None,), mesh))
    return out


def cross_attention_fwd(params: Params, x, enc_out, cfg, rt=None):
    """Decoder cross-attention: queries from x (B,Sq,D), keys and values
    from enc_out (B,Sk,D), no mask.  Past 2048 positions on either side it
    takes the chunked path (the kernel on a CUDA tensor), else dense.  With
    a mesh in ``rt`` the attention runs in :func:`attention_region`."""
    B, Sq, _ = x.shape
    Sk = enc_out.shape[1]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _heads(x @ params["wq"], H, hd)
    k = _heads(enc_out @ params["wk"], Hkv, hd)
    v = _heads(enc_out @ params["wv"], Hkv, hd)
    if cfg.qkv_bias:
        q = q + params["bq"].reshape(1, 1, H, hd)
        k = k + params["bk"].reshape(1, 1, Hkv, hd)
        v = v + params["bv"].reshape(1, 1, Hkv, hd)
    attn = chunked_attention if max(Sq, Sk) > 2048 else dense_attention

    def fn(q, k, v):
        return attn(q, k, v, causal=False, window=None)
    if rt is not None and rt.mesh is not None:
        out = attention_region(rt, fn, q, k, v)
    else:
        out = fn(q, k, v)
    return out.reshape(B, Sq, H * hd) @ attn_wo(params, cfg, rt)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg, d_ff: int | None = None) -> Params:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = cfg.torch_dtype
    if cfg.mlp_act == "swiglu":
        return Params(wg=_dense_init(gen, (d, f), dt),
                      wu=_dense_init(gen, (d, f), dt),
                      wd=_dense_init(gen, (f, d), dt))
    return Params(wu=_dense_init(gen, (d, f), dt),     # gelu 2-matrix MLP
                  bu=_zeros(gen, (f,), dt),
                  wd=_dense_init(gen, (f, d), dt),
                  bd=_zeros(gen, (d,), dt))


def mlp_fwd(params: Params, x, cfg):
    if "wg" in params:
        return (F.silu(x @ params["wg"]) * (x @ params["wu"])) @ params["wd"]
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ params["wu"] + params["bu"], approximate="tanh")
    return h @ params["wd"] + params["bd"]


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, cfg) -> Params:
    dt = cfg.torch_dtype
    p = {"table": _dense_init(gen, (cfg.padded_vocab, cfg.d_model), dt,
                              scale=0.02)}
    if cfg.pos_emb == "abs":
        p["pos"] = _dense_init(gen, (cfg.max_abs_positions, cfg.d_model), dt,
                               scale=0.02)
    return Params(**p)


def embed(params: Params, tokens, cfg, *, offset: int = 0, rt=None):
    x = embed_rows(params["table"], tokens, rt)
    if cfg.pos_emb == "abs":
        S = tokens.shape[-1]
        x = x + params["pos"][offset:offset + S]
    return x


def embed_rows(table, tokens, rt=None):
    """``table[tokens]``.  On a mesh: the table's FSDP shards gathered, and
    where its rows (the vocab) are sharded over tp each tp rank looks up
    the tokens it holds, zeros elsewhere, so the rows come back as a
    ``Partial`` sum over tp, which the next op reduces exactly (one term
    is nonzero)."""
    if rt is None or rt.mesh is None:
        return table[tokens]
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, tp = rt.mesh, rt.tp_axis
    vocab_tp = bool(tp) and rt.size(tp) > 1 and table.placements[
        mesh.mesh_dim_names.index(tp)] == Shard(0)
    dp = rt.dp_axes or None
    tspec = _spec(rt, tokens.ndim, {0: dp}, tokens.shape)
    tab = placements((tp if vocab_tp else None, None), mesh)
    out_pl = placements(tspec + (None,), mesh,
                        partial=tp if vocab_tp else ())

    def local(tab_l, tok):
        if not vocab_tp:
            return tab_l[tok]
        n = tab_l.shape[0]
        v0 = mesh.get_local_rank(tp) * n
        hit = (tok >= v0) & (tok < v0 + n)
        rows = tab_l[torch.where(hit, tok - v0, 0)]
        return rows * hit[..., None].to(rows.dtype)
    # rows looked up from different tokens on each dp rank add up
    grad_tab = placements((tp if vocab_tp else None, None), mesh,
                          partial=tspec[0] or ())
    tok_pl = placements(tspec, mesh)
    return local_map(local, out_placements=list(out_pl),
                     in_placements=(tab, tok_pl),
                     in_grad_placements=(grad_tab, tok_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def unembed(params_emb: Params, params_head: Params | None, x, cfg):
    """Project to vocab logits (fp32). Tied or separate head.  On a mesh
    the weight's FSDP shards are gathered first, so the product runs on
    each rank's own rows against the vocab-sharded weight (else DTensor
    may gather the rows of every dp rank and sum the products' partials,
    every rank holding the logits of the global batch), and the logits
    leave gathered, the vocab whole on every rank, for the cross-entropy's
    gather and log-sum-exp."""
    if params_head is None:
        logits = x.float() @ _vocab_sharded(params_emb["table"], 0).float().T
    else:
        logits = x.float() @ _vocab_sharded(params_head["w"], 1).float()
    return _whole_last_dim(logits)


def _vocab_sharded(w, vdim: int):
    """A DTensor weight with only its vocab dim ``vdim`` left sharded;
    anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(w, DTensor):
        return w
    pl = tuple(p if isinstance(p, Shard) and p.dim == vdim else Replicate()
               for p in w.placements)
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def _whole_last_dim(t):
    """A DTensor with its last dim no longer sharded; anything else as
    it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    last = t.ndim - 1
    pl = tuple(Replicate() if (isinstance(p, Shard) and p.dim == last)
               or isinstance(p, Partial) else p for p in t.placements)
    return t if pl == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def lm_head(model) -> Params | None:
    """A model's separate LM head, or None where it is tied to the
    embedding table."""
    return model["head"] if "head" in model else None


def init_lm_head(gen: torch.Generator, cfg) -> Params | None:
    if cfg.tie_embeddings:
        return None
    return Params(w=_dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                cfg.torch_dtype, scale=0.02))
