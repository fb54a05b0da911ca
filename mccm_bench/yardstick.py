"""Peaks of the card, and the work the ⟨pf, ph, pw⟩ search needs.

The peaks are NVIDIA's H100 SXM data sheet's, at its 700 W limit (a card
set below it runs slower under load, so a share against these carries the
card's power limit beside it).  The search's count is a frozen copy of
the program's own count of that kernel's work, taken at the network's own
layer count rather than the padded one, so that padding the layer axis
differently moves no yardstick.
"""
from __future__ import annotations

import torch

#: f32 outside the tensor cores, FLOP/s (H100 SXM data sheet, 700 W)
PEAK_F32_FLOPS = 67e12
#: HBM3 bandwidth, bytes/s (the same sheet)
PEAK_HBM_BYTES = 3.35e12


def search_count(pes_ce, ce_idx, n_pairs: int, n_cand: int,
                 pair_prod) -> dict:
    """Operations and bytes the search needs for these designs.

    ``pes_ce`` (B, NC) and ``ce_idx`` (B, L), L the network's own layers,
    -1 where a layer has no CE; ``pair_prod`` the P pairs' pf·ph.  Every
    input read once and the four (B, NC) f32 outputs written once.  A
    multiply and an add for each (design, layer of a CE, feasible pair of
    that CE); for each (design, CE owning a layer, pair) the quotient
    pes/(pf·ph), and for each feasible pair its floor and the argmin's
    compare; the tables every design shares: fc·coh (a multiply a live
    layer and pair) and ceil(OW/cand) (a division and a ceil a live layer
    and candidate).
    """
    B, nc = pes_ce.shape
    L = ce_idx.shape[1]
    mapped = ce_idx >= 0
    owned = torch.zeros_like(pes_ce).scatter_add_(
        1, ce_idx.clamp_min(0).long(), mapped.to(pes_ce.dtype))
    feasible = (pes_ce[:, :, None] / pair_prod[None, None, :] >= 1).sum(-1)
    walked = owned > 0
    live = int(mapped.any(0).sum())
    walk = 2 * int((owned * feasible).sum())
    per_ce = n_pairs * int(walked.sum()) + 2 * int((feasible * walked).sum())
    tables = live * n_pairs + 2 * live * n_cand
    inputs = B * nc + B * L + 2 * L * n_pairs + L + n_cand + 3 * n_pairs
    return {"flops": walk + per_ce + tables,
            "bytes": 4 * inputs + 4 * 4 * B * nc}


def least_seconds(count: dict) -> float:
    """The least time the card allows for the count: the larger of its
    bytes at the HBM rate and its operations at the f32 rate."""
    return max(count["bytes"] / PEAK_HBM_BYTES,
               count["flops"] / PEAK_F32_FLOPS)
