"""Mamba2 (SSD, state-space duality) blocks, for inference.

The PyTorch port of the JAX package's ``models/ssm.py``.  Prefill runs the
*chunked SSD* algorithm of Dao & Gu (2024): the sequence is split into
chunks of Q tokens; within a chunk the recurrence is a masked,
decay-weighted attention-like product, and across chunks an ordered loop
carries the (H, P, N) state in f32.  Decode is the O(1) recurrent step on
the carried state.

Shapes: d_inner = expand*d_model; H heads of headdim P (H*P = d_inner);
state size N (= cfg.ssm_state); G groups share the B/C projections.

Casts are the JAX package's: the products accumulate in f32 (its
``preferred_element_type=f32`` becomes an f32 product of the widened
operands, as in ``layers.py``); the intra-chunk scores, the chunk weights
and the carried states are rounded to the activation dtype before the
products that read them; ``A_log``, ``dt_bias`` and ``D`` are f32 whatever
``cfg.dtype`` is.  Everything here is torch tensor code: the JAX package
computes the scan with ``einsum``/``lax.scan``, outside any Pallas kernel.

On a mesh (``rt.mesh``) the projections are DTensor products on the
plan's shardings (``in_proj`` over fsdp and tp, ``out_proj`` over tp and
fsdp).  The in-projection's output is made whole over tp first: the z /
x / B / C / dt boundaries do not fall on its shards, where GSPMD
reshards too.  The rest runs in ``local_map`` regions on each rank's
heads (heads over tp where they divide it, else every head on every
rank): in prefill the causal conv of the rank's x channels and of every
B / C channel, the SSD scan and the skip (:func:`_mixer_region`); in
decode the conv step on the conv cache's own channel shards, then the
state update on the SSM cache's head shards, each written into the
stacked cache in place (:func:`_conv_step_region`,
:func:`_state_step_region`), on the cores one device runs whole
(:func:`_mixer_core`, :func:`_conv_step`, :func:`_state_step`).  The
gated norm and the out-projection run on the heads' DTensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Params, _dense_init, _spec, rms_norm
from .runtime import _names, placements, resolve_device


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------
def init_mamba(gen: torch.Generator, cfg) -> Params:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = di // cfg.ssm_headdim
    G, N, K = cfg.n_ssm_groups, cfg.ssm_state, cfg.ssm_conv
    dt = cfg.torch_dtype
    conv_dim = di + 2 * G * N
    dev = gen.device
    return Params(
        # fused in-projection: [z (di), x (di), B (G*N), C (G*N), dt (H)]
        in_proj=_dense_init(gen, (d, 2 * di + 2 * G * N + H), dt),
        conv_w=_dense_init(gen, (K, conv_dim), dt, scale=0.5),
        conv_b=torch.zeros(conv_dim, dtype=dt, device=dev),
        A_log=torch.zeros(H, device=dev),               # A = -exp(A_log)
        dt_bias=torch.zeros(H, device=dev),
        D=torch.ones(H, device=dev),                    # skip connection
        norm=Params(scale=torch.ones(di, dtype=dt, device=dev)),
        out_proj=_dense_init(gen, (di, d), dt))


def _split_in_proj(zxbcdt, cfg):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    G, N = cfg.n_ssm_groups, cfg.ssm_state
    H = di // cfg.ssm_headdim
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di: 2 * di]
    Bm = zxbcdt[..., 2 * di: 2 * di + G * N]
    Cm = zxbcdt[..., 2 * di + G * N: 2 * di + 2 * G * N]
    dtr = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, x, Bm, Cm, dtr, di, G, N, H


def _causal_conv(u, w, b):
    """Depthwise causal conv1d. u: (B,S,C), w: (K,C)."""
    K, S = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, K - 1, 0))
    out = torch.zeros_like(u)
    for i in range(K):              # K = 4: unrolled adds, in the JAX order
        out = out + up[:, i: i + S, :] * w[i]
    return out + b


# --------------------------------------------------------------------------
# chunked SSD (prefill)
# --------------------------------------------------------------------------
def ssd_chunked(xh, dt, A, Bm, Cm, *, chunk: int = 256, h0=None):
    """Chunked SSD scan.

    xh: (B,S,H,P) inputs; dt: (B,S,H) positive step sizes (f32);
    A: (H,) negative decay rates (f32); Bm/Cm: (B,S,G,N).
    Returns (y: (B,S,H,P) in xh's dtype, h_last: (B,H,P,N) f32).
    """
    B_, S, H, Pd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    act = xh.dtype

    # chunked views: (B, nc, Q, ...)
    xc = xh.reshape(B_, nc, Q, H, Pd)
    dtc = dt.reshape(B_, nc, Q, H)
    Bc = Bm.reshape(B_, nc, Q, G, N)
    Cc = Cm.reshape(B_, nc, Q, G, N)

    la = dtc * A                                      # log-decay a step (A<0)
    cum = torch.cumsum(la, dim=2)                     # inclusive within chunk
    dtx = xc * dtc[..., None]                         # f32: dt-scaled inputs

    # ---- intra-chunk: y[i] += C_i.B_j e^{cum_i-cum_j} dtx_j, j <= i
    Bh = Bc.repeat_interleave(rep, dim=3)             # (B,nc,Q,H,N)
    Ch = Cc.repeat_interleave(rep, dim=3)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch.float(), Bh.float())
    cum_h = cum.permute(0, 1, 3, 2)                   # (B,nc,H,Q)
    dmat = cum_h[..., :, None] - cum_h[..., None, :]  # (B,nc,H,Q,Q)
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xh.device))
    dmat = torch.where(tri, dmat, -torch.inf)         # exp(-inf) = 0
    scores = scores * torch.exp(dmat)
    del dmat
    y_intra = torch.einsum("bchqk,bckhp->bcqhp",
                           scores.to(act).float(), dtx.float())
    del scores

    # ---- chunk summary states: S_c = sum_j e^{cumQ - cum_j} B_j (x) dtx_j
    wj = torch.exp(cum_h[..., -1:] - cum_h)           # (B,nc,H,Q)
    states = torch.einsum("bchq,bcqhn,bcqhp->bchpn", wj.to(act).float(),
                          Bh.float(), dtx.float())    # (B,nc,H,P,N)
    alpha = torch.exp(cum_h[..., -1])                 # (B,nc,H) chunk decay

    # ---- inter-chunk recurrence, in chunk order: h_c = alpha_c h_{c-1} + S_c
    h = (torch.zeros(B_, H, Pd, N, dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    h_prev = [h]
    for c in range(nc):
        h = h * alpha[:, c, :, None, None] + states[:, c]
        h_prev.append(h)
    h_prev = torch.stack(h_prev[:-1], dim=1)          # state entering each chunk

    # ---- inter-chunk contribution: y[i] += C_i . (e^{cum_i} h_prev)
    win = torch.exp(cum_h)                            # (B,nc,H,Q)
    y_inter = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Ch.float(),
                           h_prev.to(act).float(), win.to(act).float())

    y = (y_intra + y_inter).to(act).reshape(B_, nc * Q, H, Pd)
    return y[:, :S], h


def mamba_fwd(params: Params, x, cfg, *, chunk: int = 256,
              return_state: bool = False, rt=None):
    """Full Mamba2 block. x: (B,S,D) -> (B,S,D) [, decode cache].  With a
    mesh in ``rt`` the conv and the scan run in :func:`_mixer_region`."""
    B_, S, _ = x.shape
    on_mesh = rt is not None and rt.mesh is not None
    zxbcdt = x @ params["in_proj"]
    if on_mesh:
        zxbcdt = rt.constrain(zxbcdt, rt.dp_axes, None, None)
    z, xs, Bm, Cm, dtr, di, G, N, H = _split_in_proj(zxbcdt, cfg)
    P_ = cfg.ssm_headdim
    # causal conv over [x, B, C]
    xbc_raw = torch.cat([xs, Bm, Cm], dim=-1)
    if on_mesh:
        y, h_last = _mixer_region(rt, params, xbc_raw, dtr, cfg, chunk)
    else:
        y, h_last = _mixer_core(params, xbc_raw, dtr, cfg, chunk, 0, H)
    y = y.reshape(B_, S, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        K = cfg.ssm_conv
        conv = (xbc_raw[:, S - (K - 1):, :] if S >= K - 1
                else F.pad(xbc_raw, (0, 0, K - 1 - S, 0)))
        return out, {"conv": conv, "ssm": h_last}
    return out


def _mixer_core(params, xbc_raw, dtr, cfg, chunk: int, h0: int, h1: int):
    """The causal conv, the SSD scan and the skip of heads [h0, h1):
    xbc_raw (B,S,di+2GN) the pre-conv [x, B, C] and dtr (B,S,H) whole,
    the conv over those heads' x channels and every B / C channel.
    Returns y (B,S,h1-h0,P) and the final state (B,h1-h0,P,N) f32."""
    B_, S, _ = xbc_raw.shape
    P_, G, N, H = cfg.ssm_headdim, cfg.n_ssm_groups, cfg.ssm_state, \
        dtr.shape[-1]
    di = H * P_
    w, b = params["conv_w"], params["conv_b"]
    if (h0, h1) != (0, H):
        c0, c1 = h0 * P_, h1 * P_
        xbc_raw = torch.cat([xbc_raw[..., c0:c1], xbc_raw[..., di:]], -1)
        w = torch.cat([w[:, c0:c1], w[:, di:]], -1)
        b = torch.cat([b[c0:c1], b[di:]], -1)
    xbc = F.silu(_causal_conv(xbc_raw, w, b))
    dl = (h1 - h0) * P_
    xs, Bm, Cm = xbc[..., :dl], xbc[..., dl:dl + G * N], xbc[..., dl + G * N:]
    dt = F.softplus(dtr[..., h0:h1].float() + params["dt_bias"][h0:h1])
    A = -torch.exp(params["A_log"][h0:h1])                # (h,)
    xh = xs.reshape(B_, S, h1 - h0, P_)
    Bm, Cm = Bm.reshape(B_, S, G, N), Cm.reshape(B_, S, G, N)
    if (h0, h1) != (0, H) and G > 1:
        # each local head's group, as a group of its own
        Bm = Bm.repeat_interleave(H // G, dim=2)[:, :, h0:h1]
        Cm = Cm.repeat_interleave(H // G, dim=2)[:, :, h0:h1]
    y, h_last = ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk)
    y = y + xh * params["D"][h0:h1][None, None, :, None].to(xh.dtype)
    return y, h_last


def _head_axis(rt, H: int):
    """tp where the H heads divide its width, else None."""
    tp = rt.tp_axis
    return tp if tp and rt.size(tp) > 1 and H % rt.size(tp) == 0 else None


def _mixer_region(rt, params, xbc_raw, dtr, cfg, chunk: int):
    """:func:`_mixer_core` on each rank's heads under ``local_map``: the
    activations' batch over the dp axes and whole over tp, the mixer's
    small parameters whole; y leaves with its heads over tp (where they
    divide it) and so does the final state.  Each rank's gradients of its
    inputs cover its heads only, so they are sums over tp, and the
    parameters' over the dp axes too."""
    from torch.distributed.tensor.experimental import local_map
    mesh = rt.mesh
    H = dtr.shape[-1]
    hax = _head_axis(rt, H)
    n_loc = H // rt.size(hax)
    dp = _spec(rt, 1, {0: rt.dp_axes or None}, dtr.shape)[0]
    part = (hax,) if hax else ()
    act = placements((dp, None, None), mesh)
    act_g = placements((dp, None, None), mesh, partial=part)
    prm_g = _names(dp) + part

    def p_in(nd):
        return placements((None,) * nd, mesh)

    def p_grad(nd):
        return placements((None,) * nd, mesh, partial=prm_g)

    def local(xbc, dtr, conv_w, conv_b, dt_bias, A_log, D):
        h0 = (mesh.get_local_rank(hax) if hax else 0) * n_loc
        prm = {"conv_w": conv_w, "conv_b": conv_b, "dt_bias": dt_bias,
               "A_log": A_log, "D": D}
        return _mixer_core(prm, xbc, dtr, cfg, chunk, h0, h0 + n_loc)
    names = ("conv_w", "conv_b", "dt_bias", "A_log", "D")
    nds = [params[n].ndim for n in names]
    return local_map(
        local,
        out_placements=(placements((dp, None, hax, None), mesh),
                        placements((dp, hax, None, None), mesh)),
        in_placements=(act, act, *(p_in(n) for n in nds)),
        in_grad_placements=(act_g, act_g, *(p_grad(n) for n in nds)),
        device_mesh=mesh, redistribute_inputs=True,
    )(xbc_raw, dtr, *(params[n] for n in names))


# --------------------------------------------------------------------------
# recurrent decode step
# --------------------------------------------------------------------------
def init_mamba_cache(cfg, batch: int, dtype=torch.float32,
                     device="cuda") -> dict:
    """One block's empty decode cache on ``device`` (``cuda`` unless the
    caller asks for another): the last K-1 pre-conv activations in
    ``dtype`` and the (H, P, N) state in f32."""
    device = resolve_device(device, "init_mamba_cache")
    d = cfg.d_model
    di = cfg.ssm_expand * d
    H = di // cfg.ssm_headdim
    G, N, K = cfg.n_ssm_groups, cfg.ssm_state, cfg.ssm_conv
    return {"conv": torch.zeros(batch, K - 1, di + 2 * G * N, dtype=dtype,
                                device=device),
            "ssm": torch.zeros(batch, H, cfg.ssm_headdim, N,
                               dtype=torch.float32, device=device)}


def mamba_step(params: Params, x, cache, cfg, rt=None, index=()):
    """One-token recurrent step. x: (B,1,D).  ``cache`` is a block's
    cache, or the stacked caches with ``index`` the block's place in them;
    the new conv window and state are written there in place.  Returns
    (y, cache).  With a mesh in ``rt`` the conv step and the state update
    run on the caches' own shards (:func:`_conv_step_region`,
    :func:`_state_step_region`)."""
    B_ = x.shape[0]
    on_mesh = rt is not None and rt.mesh is not None
    zxbcdt = x @ params["in_proj"]
    if on_mesh:
        zxbcdt = rt.constrain(zxbcdt, rt.dp_axes, None, None)
    z, xs, Bm, Cm, dtr, di, G, N, H = _split_in_proj(zxbcdt, cfg)
    xbc = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]                  # (B,C)
    if on_mesh:
        xbc_f = rt.constrain(_conv_step_region(
            rt, params, xbc, cache["conv"], index, x.dtype), rt.dp_axes, None)
        y = _state_step_region(rt, params, xbc_f, dtr[:, 0], cache["ssm"],
                               index, cfg)
    else:
        xbc_f = _conv_step(xbc, params["conv_w"], params["conv_b"],
                           cache["conv"][index], x.dtype)
        y = _state_step(xbc_f, dtr[:, 0], params["dt_bias"],
                        params["A_log"], params["D"], cache["ssm"][index],
                        cfg, 0, H)
    y = y.reshape(B_, 1, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], cache


def _conv_step(xbc, conv_w, conv_b, conv, dtype):
    """The conv window's step on the channels given: appends ``xbc`` (B,C)
    to the window ``conv`` (B,K-1,C), writes the window's last K-1
    positions back into ``conv`` in place and returns silu(conv) (B,C) in
    ``dtype``."""
    hist_dt = torch.promote_types(conv.dtype, xbc.dtype)
    hist = torch.cat([conv.to(hist_dt), xbc[:, None].to(hist_dt)], dim=1)
    out = torch.einsum("bkc,kc->bc", hist.float(), conv_w.float())
    conv.copy_(hist[:, 1:])
    return F.silu(out + conv_b.float()).to(dtype)


def _state_step(xbc_f, dtr, dt_bias, A_log, D, ssm, cfg, h0: int, h1: int):
    """The state update of heads [h0, h1): ``xbc_f`` (B,C) the conv's
    output over every channel, ``dtr`` (B,H) every head's; updates the
    heads' state ``ssm`` (B,h1-h0,P,N) in place and returns their y
    (B,h1-h0,P) with the skip."""
    H, P_, G, N = dtr.shape[-1], cfg.ssm_headdim, cfg.n_ssm_groups, \
        cfg.ssm_state
    di, B_ = H * P_, xbc_f.shape[0]
    xh = xbc_f[:, h0 * P_:h1 * P_].reshape(B_, h1 - h0, P_)
    Bm1, Cm1 = xbc_f[:, di:di + G * N], xbc_f[:, di + G * N:]
    dt = F.softplus(dtr[:, h0:h1].float() + dt_bias[h0:h1])
    A = -torch.exp(A_log[h0:h1])
    a = torch.exp(dt * A)                                        # (B,h)
    Bh = Bm1.reshape(B_, G, N).repeat_interleave(H // G, dim=1)[:, h0:h1]
    Ch = Cm1.reshape(B_, G, N).repeat_interleave(H // G, dim=1)[:, h0:h1]
    dtx = xh * dt[..., None]
    h = ssm * a[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", dtx.float(), Bh.float())
    y = torch.einsum("bhpn,bhn->bhp", h, Ch.float())
    ssm.copy_(h)
    return y.to(xbc_f.dtype) + xh * D[h0:h1][None, :, None].to(xbc_f.dtype)


def _cache_axes(cache, dim: int) -> tuple:
    """The mesh axes that shard a stacked cache's dim ``dim``."""
    from torch.distributed.tensor import Shard
    names = cache.device_mesh.mesh_dim_names
    return tuple(names[i] for i, p in enumerate(cache.placements)
                 if p == Shard(dim))


def _conv_step_region(rt, params, xbc, conv, index, dtype):
    """The conv window's step on the conv cache's own placements (its
    channels over tp where they divide it): each rank appends its channels
    of ``xbc`` (B,C) to its window, writes the window's last K-1 positions
    back in place and returns its channels' silu(conv) in ``dtype``."""
    from torch.distributed.tensor.experimental import local_map
    mesh, lead = rt.mesh, len(index)
    ch = _cache_axes(conv, lead + 2) or None
    bat = _cache_axes(conv, lead) or None
    pl = placements((bat, ch), mesh)
    wpl = placements((None, ch), mesh)

    def local(xbc, cw, cb, conv):
        return _conv_step(xbc, cw, cb, conv[index], dtype)
    return local_map(local, out_placements=list(pl),
                     in_placements=(pl, wpl, placements((ch,), mesh),
                                    tuple(conv.placements)),
                     device_mesh=mesh, redistribute_inputs=True)(
        xbc, params["conv_w"], params["conv_b"], conv)


def _state_step_region(rt, params, xbc_f, dtr, ssm, index, cfg):
    """The state update on the SSM cache's own placements (its heads over
    tp where they divide it): each rank takes its heads' x channels and
    every B / C channel of ``xbc_f`` (B,C), updates its heads' state in
    place and returns their y (B,h,P) with the skip."""
    from torch.distributed.tensor.experimental import local_map
    mesh, lead = rt.mesh, len(index)
    hax = _cache_axes(ssm, lead + 1) or None
    bat = _cache_axes(ssm, lead) or None
    n_loc = dtr.shape[-1] // rt.size(hax)

    def local(xbc_f, dtr, dt_bias, A_log, D, ssm):
        h0 = 0
        if hax:
            for a in hax:
                h0 = h0 * rt.size(a) + mesh.get_local_rank(a)
            h0 *= n_loc
        return _state_step(xbc_f, dtr, dt_bias, A_log, D, ssm[index], cfg,
                           h0, h0 + n_loc)
    rep = placements((bat, None), mesh)
    one = placements((None,), mesh)
    return local_map(local,
                     out_placements=list(placements((bat, hax, None), mesh)),
                     in_placements=(rep, rep, one, one, one,
                                    tuple(ssm.placements)),
                     device_mesh=mesh, redistribute_inputs=True)(
        xbc_f, dtr, params["dt_bias"], params["A_log"], params["D"], ssm)
