"""Mixture-of-Experts layer, single-device dispatch, for inference.

The PyTorch port of the JAX package's ``models/moe.py``, its ``local``
strategy: every expert on one device, tokens gathered into an (E, C, d)
dispatch buffer, a grouped SwiGLU over it, and each token's outputs
weighted by its gates.  Capacity-based routing as there: per call,
``C = ceil(top_k * n_tokens * cf / n_experts)`` rounded up to 8; an
assignment past its expert's capacity is dropped (GShard/Switch
semantics).

Where the JAX package's ops leave an order or an out-of-range index to
the backend, the port fixes it to what the JAX package computes on the
CPU, so that the same tokens are dropped and the same sums taken:

* the top-k breaks ties to the lower expert index (``lax.top_k``), by a
  stable descending sort;
* an assignment that is dropped is parked in a spare expert slot of the
  dispatch buffer, which is then cut off (``.at[].set`` drops
  out-of-range rows);
* each token's k weighted outputs are added left to right in assignment
  order (``.at[tok].add``), in the activation dtype, never by float
  atomics.

The router's product is f32 (an f32 router on the widened activations).
The expert-parallel strategies (``ep``, ``ep_a2a``) wait for the mesh
(``ROADMAP.md`` queue 1, item 11); ``Runtime`` refuses them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Params, _dense_init


def init_moe(gen: torch.Generator, cfg) -> Params:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = cfg.torch_dtype
    p = {"router": _dense_init(gen, (d, e), torch.float32, scale=0.02),
         "wg": _dense_init(gen, (e, d, f), dt),
         "wu": _dense_init(gen, (e, d, f), dt),
         "wd": _dense_init(gen, (e, f, d), dt)}
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = Params(wg=_dense_init(gen, (d, fs), dt),
                             wu=_dense_init(gen, (d, fs), dt),
                             wd=_dense_init(gen, (fs, d), dt))
    return Params(**p)


def _route(xf, router_w, cfg):
    """Router: top-k expert ids (n, k), normalised gates (n, k) f32, and
    the Switch-style auxiliary load-balance loss."""
    probs = torch.softmax(xf.float() @ router_w, dim=-1)         # (n, E)
    k = cfg.experts_per_token
    # lax.top_k's order: descending, equal values by ascending index
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    eidx = order[:, :k]
    gates = torch.gather(probs, 1, eidx)
    if cfg.norm_topk_prob:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    e = cfg.n_experts
    top1 = eidx[:, :1] == torch.arange(e, device=eidx.device)   # one-hot
    f_e = top1.float().mean(0)                                  # top-1 share
    aux = e * torch.sum(f_e * probs.mean(0))
    return eidx, gates, aux


def _expert_ffn(x_ecd, wg, wu, wd):
    """Grouped SwiGLU over (E, C, d) with per-expert weights (E, d, f)."""
    h = F.silu(torch.bmm(x_ecd, wg)) * torch.bmm(x_ecd, wu)
    return torch.bmm(h, wd)


def _rank_in_expert(e):
    """Each assignment's position within its expert: how many earlier
    assignments (in flattened order) went to the same expert.  The JAX
    package takes it from a cumsum down an (n*k, E) one-hot; a stable
    sort by expert gives the same integers without the one-hot, whose
    outer-dim scan took 1.18 of a 1.31 s full-width Granite prefill on an
    H100 (``chip_smoke.py`` phase 16).  Each expert's first slot in the
    sorted order comes from ``searchsorted``, which, unlike ``bincount``,
    reads nothing back to the host."""
    sorted_e, order = torch.sort(e, stable=True)
    first = torch.searchsorted(sorted_e, sorted_e)
    pos = torch.empty_like(e)
    pos[order] = torch.arange(e.numel(), device=e.device) - first
    return pos


def _dispatch_compute_combine(xf, eidx, gates, wg, wu, wd, *, e0: int,
                              e_local: int, cap: int):
    """Dispatch xf (n, d) to experts [e0, e0 + e_local), run them, and
    combine each token's gated outputs -> (n, d) in xf's dtype."""
    n, d = xf.shape
    k = eidx.shape[1]
    flat_e = eidx.reshape(-1) - e0                               # (n*k,)
    flat_g = gates.reshape(-1)
    tok = torch.arange(n, device=xf.device).repeat_interleave(k)
    local = (flat_e >= 0) & (flat_e < e_local)
    e_c = torch.where(local, flat_e, e_local)                    # park non-local
    pos = _rank_in_expert(e_c)
    keep = local & (pos < cap)
    # dropped assignments write the spare slot e_local, cut off below
    e_s = torch.where(keep, e_c, e_local)
    pos_s = torch.where(keep, pos, 0)
    x_disp = torch.zeros(e_local + 1, cap, d, dtype=xf.dtype,
                         device=xf.device)
    x_disp[e_s, pos_s] = xf[tok]
    y_ecd = _expert_ffn(x_disp[:e_local], wg, wu, wd)
    # each assignment's output, weighted by its gate (cast first, so the
    # (n*k, d) gather stays in the activation dtype); dropped ones read a
    # clipped row and are weighted by 0
    contrib = y_ecd[e_s.clamp(0, e_local - 1), pos.clamp(0, cap - 1)]
    contrib = contrib * (flat_g * keep).to(contrib.dtype)[:, None]
    contrib = contrib.view(n, k, d)
    y = contrib[:, 0]
    for j in range(1, k):                  # left to right, as .at[tok].add
        y = y + contrib[:, j]
    return y


def _capacity(n_tokens: int, cfg) -> int:
    c = math.ceil(cfg.experts_per_token * n_tokens * cfg.capacity_factor
                  / cfg.n_experts)
    # the JAX package rounds up to 8 for TPU lane alignment; kept, since
    # the capacity decides which assignments are dropped
    return max(8, -(-c // 8) * 8)


def moe_local(params: Params, x, cfg):
    """Single-device MoE. x: (B,S,D) -> (y, aux_loss)."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    eidx, gates, aux = _route(xf, params["router"], cfg)
    y = _dispatch_compute_combine(
        xf, eidx, gates, params["wg"], params["wu"], params["wd"],
        e0=0, e_local=cfg.n_experts, cap=_capacity(B * S, cfg))
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        sp = params["shared"]
        y = y + (F.silu(x @ sp["wg"]) * (x @ sp["wu"])) @ sp["wd"]
    return y, aux


def moe_fwd(params: Params, x, cfg, rt):
    """The MoE layer under the runtime's dispatch, ``local`` (the one
    ``Runtime`` admits)."""
    return moe_local(params, x, cfg)
