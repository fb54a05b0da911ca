"""Search-kernel inputs shared by the CPU tests
(``test_torch_mccm_eval.py``, against the JAX package) and the card's
(``test_torch_cuda.py``, kernel against its plain version): built from the
port alone, so the card's machine, which has no JAX, can import them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.cnn.registry import get_cnn
from repro_torch.core import batch_eval as tbe
from repro_torch.core.device import DeviceSpec
from repro_torch.core.dse import sample_mixed
from repro_torch.core.workload import Network
from repro_torch.kernels.mccm_eval import pair_tables


def port_inputs(net, pes, n, seed, device="cpu", max_L=None):
    """The search's arguments for ``n`` sample_mixed designs of ``net`` on
    a board of ``pes`` PEs, as the batch path builds them (past 65,536
    PEs the pair list is not pruned: P = 324)."""
    dev = DeviceSpec("synthetic", pes, 32 << 20, 19.2)
    t = tbe.make_tables(net, max_L=max_L, device=device)
    db = sample_mixed(np.random.default_rng(seed), len(net), n)
    m = tbe._ce_maps(db.to(device), t,
                     tbe.make_device_tables(dev, device=device))
    search = tbe._pair_layer_tables(
        t, pair_tables(t.candidates, tbe.pes_hint(pes)))
    return [m.pes_ce, tbe._search_ce(m), *search]


def synthetic_net(n_layers):
    """A net of ``n_layers`` conv layers: ResNet-152's, ResNet-101's, then
    ResNet-50's, renumbered (past 160 layers the batch path pads it to the
    next multiple of 32)."""
    layers = sum((get_cnn(n).layers for n in
                  ("resnet152", "resnet101", "resnet50")), ())
    return Network(f"synthetic{n_layers}", tuple(
        l.replace(index=i, name=f"s{i}")
        for i, l in enumerate(layers[:n_layers])))


def give_absent_ces_pes(args, seed):
    """Give every CE that owns no layer some PEs (sample_mixed leaves them
    at 0), from too few for any pair to the whole board; returns the
    (B, NC) mask of those CEs."""
    ce = args[1]
    absent = torch.stack([(ce != c).all(1) for c in range(16)], 1)
    rng = np.random.default_rng(seed)
    pes = args[0].clone()
    pes[absent] = torch.from_numpy(rng.choice(
        [0.5, 1.0, 3.0, 7.0, 100.0, 2520.0], int(absent.sum()))
        .astype(np.float32)).to(pes.device)
    args[0] = pes
    return absent


def tie_inputs(B=6, L=40, P=400, K=20, seed=8, device="cpu"):
    """Search arguments built for ties: 400 pairs (two groups of a lane's
    352 in the kernel), whose fc, coh and pf·ph repeat every 7 pairs, so
    pairs 7 apart cost the same; half the layers of each design on CE 0,
    the rest spread over CEs 1-3, the last 3 on none."""
    rng = np.random.default_rng(seed)
    # ascending from 1, as every candidate list (the Pallas kernel takes a
    # pw below the first candidate as 1)
    cand = np.cumsum(np.r_[1, rng.integers(1, 4, K - 1)]).astype(np.float32)
    rep = -(-P // 7)
    fc = np.tile(rng.integers(1, 40, (L, 7)).astype(np.float32),
                 (1, rep))[:, :P]
    coh = np.tile(rng.integers(1, 9, (L, 7)).astype(np.float32),
                  (1, rep))[:, :P]
    prod = np.tile(np.array([1, 2, 4, 4, 6, 9, 12], np.float32), rep)[:P]
    ce = rng.integers(1, 4, (B, L)).astype(np.int32)
    ce[:, ::2] = 0
    ce[:, -3:] = -1
    pes = rng.choice([5.0, 12.0, 40.0, 0.0], (B, 16)).astype(np.float32)
    ow = rng.integers(1, 60, L).astype(np.float32)
    pf = np.arange(P, dtype=np.float32) % 5 + 1
    ph = np.arange(P, dtype=np.float32) % 3 + 1
    return [torch.from_numpy(a).to(device) for a in
            (pes, ce, fc, coh, ow, cand, prod, pf, ph)]
