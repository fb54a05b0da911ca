"""Mixture-of-Experts layer with expert parallelism.

The PyTorch port of the JAX package's ``models/moe.py``.  Three
strategies with the same math:

* ``local``: every expert on one device, tokens gathered into an (E, C, d)
  dispatch buffer, a grouped SwiGLU over it, and each token's outputs
  weighted by its gates (on a mesh: every rank runs the whole layer on
  all tokens, the JAX package's ``local`` under GSPMD);
* ``ep`` (:func:`moe_ep`): on a mesh, tokens sharded over the dp axes and
  replicated over the expert axis, experts sharded over it; each rank
  routes its tokens, runs the assignments to its own experts, and the
  partial outputs are summed over the expert axis;
* ``ep_a2a`` (:func:`moe_ep_a2a`): tokens sharded over the dp axes (batch)
  and the expert axis (sequence); each rank routes its own tokens into an
  (E, C, d) buffer and two all-to-alls move the expert blocks to the rank
  that owns them and back.

Both expert-parallel strategies run in a ``local_map`` region, the JAX
package's ``shard_map``: routing, capacity and the aux loss are each
rank's own (shard-local), ``e0 = axis_index·e_local``, and the aux is
averaged over the axes the JAX package's ``pmean`` names (dp for ``ep``;
dp and the expert axis for ``ep_a2a``).  :func:`moe_fwd` takes ``ep_a2a``
where the sequence divides by the expert axis's width, else ``ep`` (a
decode step's one token too).  Capacity-based routing as there: per call
and shard, ``C = ceil(top_k * n_tokens * cf / n_experts)`` rounded up to
8; an assignment past its expert's capacity is dropped (GShard/Switch
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
Inside each shard the same order holds: ties, drops and the left-to-right
sums are the local route's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import collectives as C
from .layers import Params, _dense_init
from .runtime import placements


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
                              e_local: int, cap: int, ffn=None):
    """Dispatch xf (n, d) to experts [e0, e0 + e_local), run them (the
    grouped SwiGLU on wg/wu/wd, or ``ffn`` on the (e_local, cap, d)
    buffer), and combine each token's gated outputs -> (n, d) in xf's
    dtype."""
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
    ffn = ffn or (lambda xd: _expert_ffn(xd, wg, wu, wd))
    y_ecd = ffn(x_disp[:e_local])
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
    return _shared(params, x, cfg, y.reshape(B, S, D)), aux


def _shared(params: Params, x, cfg, y):
    """y plus the shared experts' output on x.  On a mesh y first takes
    x's placements (``moe_ep_a2a``'s leaves sequence-sharded), so the sum
    and the gradient that reaches the shared experts' products keep x's
    layout: torch 2.11 cannot flatten a (B, S, D) gradient sharded on both
    B and S into the products' rows."""
    if cfg.n_shared_experts:
        from torch.distributed.tensor import DTensor
        if isinstance(y, DTensor) and y.placements != x.placements:
            y = y.redistribute(x.device_mesh, x.placements)
        sp = params["shared"]
        y = y + (F.silu(x @ sp["wg"]) * (x @ sp["wu"])) @ sp["wd"]
    return y


def _ep_region(params: Params, x, rt, local_fn, x_spec):
    """``local_fn(x_l, router, wg, wu, wd) -> (y_l, aux_l)`` under
    ``local_map``: x on ``x_spec``, the router replicated, the experts
    sharded over the expert axis (their FSDP shards gathered).

    Where x is replicated over the expert axis (``ep``) each rank holds its
    experts' part of y, so y leaves as a sum over it, and so does x's
    gradient.  The router's gradient is summed over the token axes and the
    expert axis, the experts' over the token axes.  aux leaves as a sum of
    aux/n over those n ranks: the mean over the token axes (the JAX
    package's ``pmean``), whose value the expert axis's ranks repeat where
    they route the same tokens; a repeated aux's gradient is then 1/n of
    it on each rank."""
    from torch.distributed.tensor.experimental import local_map
    mesh, ep = rt.mesh, rt.ep_axis
    tok = tuple(a for e in x_spec if e
                for a in ((e,) if isinstance(e, str) else e))
    y_sum = () if ep in tok else (ep,)
    route = tok + y_sum
    n_route = rt.size(route)

    def fn(x_l, router, wg, wu, wd):
        y, aux = local_fn(x_l, router, wg, wu, wd)
        return y, aux / n_route
    xs = (x_spec, mesh)
    wspec = (ep, None, None)
    w_in = placements(wspec, mesh)
    w_grad = placements(wspec, mesh, partial=tuple(a for a in tok
                                                   if a != ep))
    y, aux = local_map(
        fn,
        out_placements=(placements(*xs, partial=y_sum),
                        placements((), mesh, partial=route)),
        in_placements=(placements(*xs), placements((None, None), mesh),
                       w_in, w_in, w_in),
        in_grad_placements=(placements(*xs, partial=y_sum),
                            placements((None, None), mesh, partial=route),
                            w_grad, w_grad, w_grad),
        device_mesh=mesh, redistribute_inputs=True,
    )(x, params["router"], params["wg"], params["wu"], params["wd"])
    return y, aux


def moe_ep(params: Params, x, cfg, rt):
    """Expert-parallel MoE, the partial-sum variant (module docstring)."""
    mesh, ep = rt.mesh, rt.ep_axis
    e_local = -(-cfg.n_experts // rt.size(ep))

    def local_fn(x_l, router_w, wg, wu, wd):
        B, S, D = x_l.shape
        xf = x_l.reshape(B * S, D)
        eidx, gates, aux = _route(xf, router_w, cfg)
        e0 = mesh.get_local_rank(ep) * e_local
        y = _dispatch_compute_combine(
            xf, eidx, gates, wg, wu, wd, e0=e0, e_local=e_local,
            cap=_capacity(B * S, cfg))
        return y.reshape(B, S, D), aux
    dp = rt.dp_axes or None
    y, aux = _ep_region(params, x, rt, local_fn, (dp, None, None))
    return _shared(params, x, cfg, y), aux


def moe_ep_a2a(params: Params, x, cfg, rt):
    """All-to-all dispatch variant (module docstring): per layer
    2·k·cf·tokens_local·d bytes on the wire."""
    mesh, ep = rt.mesh, rt.ep_axis
    n_ep = rt.size(ep)
    E = cfg.n_experts
    e_local = -(-E // n_ep)

    def local_fn(x_l, router_w, wg, wu, wd):
        B, S, D = x_l.shape
        n = B * S
        xf = x_l.reshape(n, D)
        eidx, gates, aux = _route(xf, router_w, cfg)
        cap = _capacity(n, cfg)

        def exchange(x_disp):                       # (E, cap, D)
            # (ep, e_local, C, d): block i to the rank owning experts i
            x_recv = C.all_to_all(x_disp.reshape(n_ep, e_local, cap, D),
                                  mesh, ep)
            x_mine = x_recv.transpose(0, 1).reshape(e_local, n_ep * cap, D)
            y_mine = _expert_ffn(x_mine, wg, wu, wd)
            y_send = y_mine.reshape(e_local, n_ep, cap, D).transpose(0, 1)
            return C.all_to_all(y_send, mesh, ep).reshape(E, cap, D)
        y = _dispatch_compute_combine(xf, eidx, gates, None, None, None,
                                      e0=0, e_local=E, cap=cap,
                                      ffn=exchange)
        return y.reshape(B, S, D), aux
    dp = rt.dp_axes or None
    y, aux = _ep_region(params, x, rt, local_fn, (dp, ep, None))
    return _shared(params, x, cfg, y), aux


def _moe_replicated(params: Params, x, cfg, rt):
    """``local`` on a mesh: every rank runs the whole layer on all the
    tokens (the global routing)."""
    from torch.distributed.tensor.experimental import local_map
    mesh = rt.mesh
    rep = placements((), mesh)
    names = ("router", "wg", "wu", "wd")
    sub = Params(**{k: params[k] for k in names})

    def fn(x_l, *ws):
        p = dict(zip(names, ws))
        B, S, D = x_l.shape
        xf = x_l.reshape(B * S, D)
        eidx, gates, aux = _route(xf, p["router"], cfg)
        y = _dispatch_compute_combine(
            xf, eidx, gates, p["wg"], p["wu"], p["wd"], e0=0,
            e_local=cfg.n_experts, cap=_capacity(B * S, cfg))
        return y.reshape(B, S, D), aux
    y, aux = local_map(fn, out_placements=(rep, rep),
                       in_placements=(rep,) * 5, device_mesh=mesh,
                       redistribute_inputs=True)(
        x, *(sub[k] for k in names))
    return _shared(params, x, cfg, y), aux


def moe_fwd(params: Params, x, cfg, rt):
    """Dispatch on the runtime's MoE strategy: ``local`` without a mesh;
    on one, ``ep_a2a`` where the sequence divides by the expert axis's
    width, else ``ep`` (a one-token decode step cannot shard its
    sequence)."""
    if rt.mesh is None:
        return moe_local(params, x, cfg)
    if rt.moe_impl == "local":
        return _moe_replicated(params, x, cfg, rt)
    if rt.moe_impl == "ep_a2a" and x.shape[1] % rt.size(rt.ep_axis) == 0:
        return moe_ep_a2a(params, x, cfg, rt)
    return moe_ep(params, x, cfg, rt)
