"""Inputs of the MCCM kernels (the search, the Eq. 1 latency sweep) shared
by the CPU tests (``test_torch_mccm_eval.py``, against the JAX package) and
the card's (``test_torch_cuda.py``, kernel against its plain version):
built from the port alone, so the card's machine, which has no JAX, can
import them.
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


# ------------------------------------------------------------ mccm_latency
def latency_inputs(B, L, seed):
    """dims (L, 4) of integer layer sizes and par (B, L, 3) drawn from the
    parallelism candidates, as numpy f32."""
    rng = np.random.default_rng(seed)
    dims = rng.integers(1, 4096, (L, 4)).astype(np.float32)
    par = rng.choice([1, 2, 3, 7, 24, 64, 512], (B, L, 3)).astype(np.float32)
    return dims, par


def latency_nonfinite_inputs(kind, B=37, L=53, seed=5):
    """:func:`latency_inputs` with a fifth of the even designs' par set to
    ``kind`` (0, inf or nan; half of them negative, some -3) and a few dims
    to 0 (and layer 1's CKK to inf for ``kind`` inf): F/0 is inf (NaN
    where F is 0 too), 0 over a negative divisor is -0, F/inf is 0, and
    inf·0 is NaN, so inf and NaN reach the cycles and the totals in every
    kind, beside the odd designs' totals."""
    dims, par = latency_inputs(B, L, seed)
    rng = np.random.default_rng(seed + 1)
    value = {"zero": 0.0, "inf": np.inf, "nan": np.nan}[kind]
    hit = rng.random(par.shape) < 0.2
    hit[1::2] = False
    par[hit] = value
    # and signed: -0 gives -inf, and a zero numerator over a negative
    # divisor a -0
    par[hit & (rng.random(par.shape) < 0.5)] = -value
    par[hit & (rng.random(par.shape) < 0.2)] = -3.0
    dims[rng.random(dims.shape) < 0.1] = 0.0
    if kind == "inf":
        dims[1] = 7.0, value, 5.0, 5.0
    return dims, par


def latency_order_inputs(B=4, L=160):
    """dims and par whose totals the order of the sum decides: a first
    layer of 2**25 cycles, then L - 1 odd small ones (3, 5, 7, 3, ...), at
    ⟨1, 1, 1⟩ in every design.  In f32, 2**25 plus each small one rounds
    to a multiple of 4; a tree adds the small ones exactly first."""
    dims = np.ones((L, 4), np.float32)
    dims[0, 0] = 2.0 ** 25
    dims[1:, 0] = 3 + 2 * (np.arange(L - 1) % 3)
    return dims, np.ones((B, L, 3), np.float32)


def ascending_sum(cyc):
    """Each row of (B, L) ``cyc`` added left to right in f32."""
    acc = np.asarray(cyc[:, 0], np.float32).copy()
    for l in range(1, cyc.shape[1]):
        acc = (acc + np.asarray(cyc[:, l], np.float32)).astype(np.float32)
    return acc


def tree_sum(cyc):
    """Each row of (B, L) ``cyc`` added pairwise, halves first, in f32."""
    cyc = np.asarray(cyc, np.float32)
    if cyc.shape[1] == 1:
        return cyc[:, 0]
    h = cyc.shape[1] // 2
    return (tree_sum(cyc[:, :h]) + tree_sum(cyc[:, h:])).astype(np.float32)
