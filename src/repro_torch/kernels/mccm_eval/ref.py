"""Plain PyTorch versions of the MCCM evaluation kernels.

``mccm_latency_ref`` is the Eq. 1 sweep, the JAX package's
``kernels/mccm_eval/ref.py::mccm_latency_ref`` with the per-design total
added left to right over the layers, the order the CUDA kernel
(``csrc/mccm_latency.cu``) keeps, so that the two agree bit for bit.

``parallelism_search_ref`` is the port of the JAX package's
``parallelism_search_ref``.  It is what a CPU tensor runs, and what the CUDA
kernel (``csrc/parallelism_search.cu``) is held against on the card.  Both
take the same arguments: one CE index per layer (where the JAX version
takes the index and its one-hot) and the raw ``ow`` column (where it takes
the ``ceil(OW/cand)`` table; the f32 quotient of two integers below 2**24
rounds to the same ceil).

For every design and CE it picks the candidate pair minimising the CE's
total Eq. 1 cycles under its PE budget, with ``pw`` greedily maximised per
pair.  The per-CE cost is a sum of per-layer f32 costs that can exceed
2**24, so its rounding depends on the order of the sum: it is taken layer
by layer in ascending order, the order the JAX reference's compiled
contraction uses on a CPU and the order the CUDA kernel walks the layers
in.  Equal order gives equal costs, and so equal argmins.
"""
from __future__ import annotations

import torch


def mccm_latency_ref(dims, par):
    """Eq. 1 over a design batch.

    dims: (L, 4) f32 — per-layer (F, CKK, OH, OW);
    par : (B, L, 3) f32 — per-design per-layer ⟨pf, ph, pw⟩ (already
          gathered from the layer's CE).
    Returns (B,) total cycles and (B, L) per-layer cycles
    ``ceil(F/pf)·CKK·ceil(OH/ph)·ceil(OW/pw)``, multiplied left to right as
    ``batch_eval.layer_state`` computes its ``comp``.  The total adds the L
    cycles in ascending layer order.
    """
    F, CKK, OH, OW = dims.unbind(1)
    cyc = (torch.ceil(F[None] / par[..., 0]) * CKK[None]
           * torch.ceil(OH[None] / par[..., 1])
           * torch.ceil(OW[None] / par[..., 2]))
    tot = cyc[:, 0]
    for l in range(1, cyc.shape[1]):
        tot = tot + cyc[:, l]
    return tot, cyc


def parallelism_search_ref(pes_ce, ce_idx, fc_pair, coh_pair, ow, cand,
                           pair_prod, pair_pf, pair_ph):
    """Fused per-CE parallelism search.

    Arguments (all on one device)
    -----------------------------
    pes_ce    (B, NC)  f32  PEs allocated to each CE.
    ce_idx    (B, L)   int  CE of each layer, -1 for a layer with no CE
                            (padded, or past NC on a non-canonical row).
    fc_pair   (L, P)   f32  ceil(F/pf) * CKK per (layer, pair).
    coh_pair  (L, P)   f32  ceil(OH/ph) per (layer, pair).
    ow        (L,)     f32  output width of each layer.
    cand      (K,)     f32  ascending parallelism candidates.
    pair_prod (P,)     f32  pf*ph of each pair (row-major pair order).
    pair_pf/ph (P,)    f32  pf / ph candidate values of each pair.

    Returns (pf, ph, pw, cost) each (B, NC) f32: the per-CE winner and its
    total cycle cost (inf when no pair is feasible, with ⟨pf, ph, pw⟩ then
    the first pair and the first candidate).
    """
    B, L = ce_idx.shape
    nc = pes_ce.shape[1]
    ncand = cand.shape[0]
    ce = ce_idx.long()
    ce_oh = (ce[..., None] == torch.arange(nc, device=ce.device)).to(
        pes_ce.dtype)                                           # (B, L, NC)
    budget = pes_ce[:, :, None] / pair_prod[None, None, :]      # (B, NC, P)
    feasible = budget >= 1.0
    # largest candidate with pf*ph*pw <= pes: searchsorted on the floor
    pw_idx = (torch.searchsorted(cand.contiguous(), torch.floor(budget),
                                 right=True) - 1).clamp(0, ncand - 1)
    pw_sel = torch.take_along_dim(
        pw_idx, ce.clamp_min(0)[:, :, None], dim=1)             # (B, L, P)
    ceil_ow = torch.ceil(ow.reshape(L, 1) / cand[None, :])      # (L, K)
    layer = torch.arange(L, device=pw_sel.device)[None, :, None]
    cow = ceil_ow[layer, pw_sel]                                # (B, L, P)
    cost_l = fc_pair[None] * coh_pair[None] * cow               # (B, L, P)
    # layer -> CE contraction, one layer at a time in ascending order
    cost_ce = torch.zeros(B, nc, cost_l.shape[2],
                          dtype=cost_l.dtype, device=cost_l.device)
    for l in range(L):
        cost_ce = cost_ce + cost_l[:, l, None, :] * ce_oh[:, l, :, None]
    cost_ce = torch.where(feasible, cost_ce, torch.inf)
    best = torch.argmin(cost_ce, dim=-1)                        # (B, NC)
    pf = pair_pf[best]
    ph = pair_ph[best]
    pw = cand[torch.take_along_dim(pw_idx, best[..., None], -1)[..., 0]]
    cost = torch.take_along_dim(cost_ce, best[..., None], -1)[..., 0]
    return pf, ph, pw, cost
