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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Params, _dense_init, rms_norm
from .runtime import resolve_device


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
              return_state: bool = False):
    """Full Mamba2 block. x: (B,S,D) -> (B,S,D) [, decode cache]."""
    B_, S, _ = x.shape
    z, xs, Bm, Cm, dtr, di, G, N, H = _split_in_proj(
        x @ params["in_proj"], cfg)
    P_ = cfg.ssm_headdim
    # causal conv over [x, B, C]
    xbc_raw = torch.cat([xs, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv(xbc_raw, params["conv_w"], params["conv_b"]))
    xs, Bm, Cm = xbc[..., :di], xbc[..., di:di + G * N], xbc[..., di + G * N:]

    dt = F.softplus(dtr.float() + params["dt_bias"])     # (B,S,H) f32
    A = -torch.exp(params["A_log"])                      # (H,)
    xh = xs.reshape(B_, S, H, P_)
    y, h_last = ssd_chunked(xh, dt, A, Bm.reshape(B_, S, G, N),
                            Cm.reshape(B_, S, G, N), chunk=chunk)
    y = y + xh * params["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B_, S, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    if return_state:
        K = cfg.ssm_conv
        conv = (xbc_raw[:, S - (K - 1):, :] if S >= K - 1
                else F.pad(xbc_raw, (0, 0, K - 1 - S, 0)))
        return out, {"conv": conv, "ssm": h_last}
    return out


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


def mamba_step(params: Params, x, cache, cfg):
    """One-token recurrent step. x: (B,1,D). Returns (y, new_cache)."""
    B_ = x.shape[0]
    z, xs, Bm, Cm, dtr, di, G, N, H = _split_in_proj(
        x @ params["in_proj"], cfg)
    P_ = cfg.ssm_headdim
    xbc = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]                  # (B,C)
    hist_dt = torch.promote_types(cache["conv"].dtype, xbc.dtype)
    hist = torch.cat([cache["conv"].to(hist_dt),
                      xbc[:, None].to(hist_dt)], dim=1)          # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", hist.float(),
                            params["conv_w"].float())
    xbc_f = F.silu(conv_out + params["conv_b"].float()).to(x.dtype)
    xs1, Bm1, Cm1 = (xbc_f[:, :di], xbc_f[:, di:di + G * N],
                     xbc_f[:, di + G * N:])
    dt = F.softplus(dtr[:, 0].float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    a = torch.exp(dt * A)                                        # (B,H)
    xh = xs1.reshape(B_, H, P_)
    Bh = Bm1.reshape(B_, G, N).repeat_interleave(H // G, dim=1)  # (B,H,N)
    Ch = Cm1.reshape(B_, G, N).repeat_interleave(H // G, dim=1)
    dtx = xh * dt[..., None]
    h = cache["ssm"] * a[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", dtx.float(), Bh.float())
    y = torch.einsum("bhpn,bhn->bhp", h, Ch.float())
    y = y.to(x.dtype) + xh * params["D"][None, :, None].to(x.dtype)
    y = y.reshape(B_, 1, di)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    new_cache = {"conv": hist[:, 1:].to(cache["conv"].dtype), "ssm": h}
    return y @ params["out_proj"], new_cache
